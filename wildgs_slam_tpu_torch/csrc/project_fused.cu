// P1 / P2: the mapping render's projection, from the post-activation
// Gaussians to the (N, 16) rows that K3 gathers, and its backward.
//
// P1 `project_fwd` does in one launch what the chain of elementwise PyTorch
// operations of ops/rasterizer/projection.py::project_gaussians followed by
// `pack_attrs` does in ~250: one thread per Gaussian row, over the whole
// capacity, writes
//   attrs[n]  = (mean2d + offset, conic a/b/c, colour, opacity, depth, 0 x 6),
//   radius[n] = the integer 3-sigma radius, 0 where the row is not valid,
//   valid[n]  = near, det > 0 and in-image culling, and `alive`,
//   mean2d[n] (+ offset) and depth[n], the binning's inputs.
// P2 `project_bwd` (~330 launches before) takes the cotangent of attrs (K4's
// output) and writes the gradients of means3d, scales, rotations, opacities,
// the SH coefficients and mean2d_offset. A row that is not valid gets zeros:
// no tile slot reads it, so its cotangent is zero on the render path. Given a
// buffer for it, P2 also writes each block's float64 sum of its rows'
// gradients of the camera (the w2c 7-vector), and `pose_sum_kernel` adds the
// blocks in a fixed order, so that two calls give the same bits. Without the
// buffer (the camera takes no gradient) neither is done.
//
// Arithmetic. The file is built with --fmad=false, uses IEEE division and
// square root, and follows project_gaussians' operations in their order as
// PyTorch runs them on the card, one kernel per operation: so the floats
// round as there, and the integer outputs (radius, valid) and thus the
// binning's ids equal the plain path's. Two places follow PyTorch's kernels
// rather than the Python text: `x / t` for a Python number x is
// `t.reciprocal() * x`, and each component a*b - c*d of torch.linalg.cross
// (one kernel, built with contraction) is fma(a, b, -(c*d)).
//
// SH: degree 0, as in every configuration: colour = max(C0 sh[n, 0] + 0.5, 0)
// per channel; sh has K coefficients a row (a row stride of 3K floats), and
// the gradients of those past the first are zero. A higher degree is
// refused by the caller (ops/rasterizer/projection_cuda.py::project_rows).
//
// Bound on the H100: bytes. About 215 fp32 operations a row forward and twice
// that backward, against 146 bytes a row read and written forward and 165
// backward (65 on a row that is not valid): at 67 TFLOP/s and 3.35 TB/s the
// bytes take longer.
//
// Design: the camera (w2c, intrinsics) is read by every thread from two
// small device buffers (one broadcast load each) and its rotation matrix
// recomputed in registers, so no host read and no per-component tensor is
// needed. P2 recomputes the forward's intermediates from the inputs instead
// of storing them (recomputing costs ~200 operations a row; storing would
// move ~150 bytes a row more). Row loads are scalar (rows of 3 floats), the
// packed rows and their cotangents move as float4.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ATTR_F = 16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int POSE_F = 7;
constexpr float SH_C0 = 0.28209479177387814f;

// one component of torch.linalg.cross on the card
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
  return __fmaf_rn(a, b, -(c * d));
}

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float out[3]) {
  out[0] = cross_term(a[1], b[2], a[2], b[1]);
  out[1] = cross_term(a[2], b[0], a[0], b[2]);
  out[2] = cross_term(a[0], b[1], a[1], b[0]);
}

// lie.quat_to_matrix of q = (x, y, z, w)
__device__ __forceinline__ void quat_to_matrix(const float q[4],
                                               float R[3][3]) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0][0] = 1.0f - 2.0f * (yy + zz);
  R[0][1] = 2.0f * (xy - wz);
  R[0][2] = 2.0f * (xz + wy);
  R[1][0] = 2.0f * (xy + wz);
  R[1][1] = 1.0f - 2.0f * (xx + zz);
  R[1][2] = 2.0f * (yz - wx);
  R[2][0] = 2.0f * (xz - wy);
  R[2][1] = 2.0f * (yz + wx);
  R[2][2] = 1.0f - 2.0f * (xx + yy);
}

// g += the gradient of quat_to_matrix's q, given that of its matrix
__device__ __forceinline__ void quat_to_matrix_vjp(const float q[4],
                                                   const float gR[3][3],
                                                   float g[4]) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  g[0] += 2.0f * y * (gR[0][1] + gR[1][0]) + 2.0f * z * (gR[0][2] + gR[2][0])
          + 2.0f * w * (gR[2][1] - gR[1][2])
          - 4.0f * x * (gR[1][1] + gR[2][2]);
  g[1] += 2.0f * x * (gR[0][1] + gR[1][0]) + 2.0f * w * (gR[0][2] - gR[2][0])
          + 2.0f * z * (gR[1][2] + gR[2][1])
          - 4.0f * y * (gR[0][0] + gR[2][2]);
  g[2] += 2.0f * w * (gR[1][0] - gR[0][1]) + 2.0f * x * (gR[0][2] + gR[2][0])
          + 2.0f * y * (gR[1][2] + gR[2][1])
          - 4.0f * z * (gR[0][0] + gR[1][1]);
  g[3] += 2.0f * z * (gR[1][0] - gR[0][1]) + 2.0f * y * (gR[0][2] - gR[2][0])
          + 2.0f * x * (gR[2][1] - gR[1][2]);
}

struct Camera {
  float t[3], q[4];   // w2c: translation, quaternion (x, y, z, w)
  float R[3][3];      // quat_to_matrix(q)
  float fx, fy, cx, cy, limx, limy;
};

__device__ __forceinline__ Camera load_camera(const float* w2c,
                                              const float* intr, int H,
                                              int W) {
  Camera c;
  for (int k = 0; k < 3; ++k) c.t[k] = w2c[k];
  for (int k = 0; k < 4; ++k) c.q[k] = w2c[3 + k];
  quat_to_matrix(c.q, c.R);
  c.fx = intr[0];
  c.fy = intr[1];
  c.cx = intr[2];
  c.cy = intr[3];
  // 1.3 * ((0.5 * W) / fx), a Python number over a tensor
  c.limx = 1.3f * ((1.0f / c.fx) * (float)(0.5 * W));
  c.limy = 1.3f * ((1.0f / c.fy) * (float)(0.5 * H));
  return c;
}

// One row's projection up to the 2D covariance, every intermediate kept for
// the backward (the forward kernel's compile drops those it does not read).
struct Row {
  float m[3], tt[3], t[3];
  float tzs, inv_z, inv_z2, r[2], rc[2], txz, tyz;
  float j00, j02, j11, j12, u[3], v[3];
  float rot[4], R[3][3], s[3], P[3], Q[3], p[3], q[3];
  float a, b, c, det, inv_det;
};

__device__ __forceinline__ void project_row(const Camera& cam,
                                            const float* __restrict__ means,
                                            const float* __restrict__ scales,
                                            const float* __restrict__ rots,
                                            long long n, float sm, Row& o) {
  for (int k = 0; k < 3; ++k) o.m[k] = means[3 * n + k];
  // lie.se3_act: quat_act(q, m) + t, quat_act = m + w tt + v x tt with
  // tt = 2 v x m
  const float qv[3] = {cam.q[0], cam.q[1], cam.q[2]};
  float c1[3], c2[3];
  cross(qv, o.m, c1);
  for (int k = 0; k < 3; ++k) o.tt[k] = 2.0f * c1[k];
  cross(qv, o.tt, c2);
  for (int k = 0; k < 3; ++k)
    o.t[k] = ((o.m[k] + cam.q[3] * o.tt[k]) + c2[k]) + cam.t[k];

  const float tz = o.t[2];
  o.tzs = fabsf(tz) < 1e-6f ? 1e-6f : tz;
  o.r[0] = o.t[0] / o.tzs;
  o.r[1] = o.t[1] / o.tzs;
  o.rc[0] = fmaxf(fminf(o.r[0], cam.limx), -cam.limx);
  o.rc[1] = fmaxf(fminf(o.r[1], cam.limy), -cam.limy);
  o.txz = o.rc[0] * o.tzs;
  o.tyz = o.rc[1] * o.tzs;

  o.inv_z = 1.0f / o.tzs;
  o.inv_z2 = o.inv_z * o.inv_z;
  o.j00 = cam.fx * o.inv_z;
  o.j02 = (-cam.fx * o.txz) * o.inv_z2;
  o.j11 = cam.fy * o.inv_z;
  o.j12 = (-cam.fy * o.tyz) * o.inv_z2;
  for (int k = 0; k < 3; ++k) {
    o.u[k] = o.j00 * cam.R[0][k] + o.j02 * cam.R[2][k];
    o.v[k] = o.j11 * cam.R[1][k] + o.j12 * cam.R[2][k];
  }

  for (int k = 0; k < 4; ++k) o.rot[k] = rots[4 * n + k];
  quat_to_matrix(o.rot, o.R);
  for (int j = 0; j < 3; ++j) {
    o.s[j] = scales[3 * n + j] * sm;
    o.P[j] = (o.R[0][j] * o.u[0] + o.R[1][j] * o.u[1]) + o.R[2][j] * o.u[2];
    o.Q[j] = (o.R[0][j] * o.v[0] + o.R[1][j] * o.v[1]) + o.R[2][j] * o.v[2];
    o.p[j] = o.s[j] * o.P[j];
    o.q[j] = o.s[j] * o.Q[j];
  }
  o.a = ((o.p[0] * o.p[0] + o.p[1] * o.p[1]) + o.p[2] * o.p[2]) + 0.3f;
  o.b = (o.p[0] * o.q[0] + o.p[1] * o.q[1]) + o.p[2] * o.q[2];
  o.c = ((o.q[0] * o.q[0] + o.q[1] * o.q[1]) + o.q[2] * o.q[2]) + 0.3f;
  o.det = o.a * o.c - o.b * o.b;
  o.inv_det = 1.0f / (o.det <= 0.0f ? 1.0f : o.det);
}

__global__ void __launch_bounds__(THREADS) project_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ scales,
    const float* __restrict__ rots, const float* __restrict__ opac,
    const float* __restrict__ sh, const uint8_t* __restrict__ alive,
    const float* __restrict__ offset, const float* __restrict__ w2c,
    const float* __restrict__ intr, float4* __restrict__ attrs,
    int* __restrict__ radius, uint8_t* __restrict__ valid,
    float* __restrict__ mean2d, float* __restrict__ depth, int N, int K,
    int H, int W, float sm, float near) {
  const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const Camera cam = load_camera(w2c, intr, H, W);
  Row o;
  project_row(cam, means, scales, rots, n, sm, o);

  const float ca = o.c * o.inv_det, cb = -o.b * o.inv_det,
              cc = o.a * o.inv_det;
  const float mid = 0.5f * (o.a + o.c);
  const float lam1 = mid + sqrtf(fmaxf(mid * mid - o.det, 0.1f));
  const int rad = (int)ceilf(3.0f * sqrtf(lam1));
  float mx = ((cam.fx * o.t[0]) * o.inv_z + cam.cx) - 0.5f;
  float my = ((cam.fy * o.t[1]) * o.inv_z + cam.cy) - 0.5f;
  const float fr = (float)rad;
  const bool in_image = (mx + fr > 0.0f) && (mx - fr < (float)W) &&
                        (my + fr > 0.0f) && (my - fr < (float)H);
  const bool ok = (o.t[2] > near) && (o.det > 0.0f) && in_image &&
                  (alive == nullptr || alive[n] != 0);
  if (offset != nullptr) {
    mx = mx + offset[2 * n];
    my = my + offset[2 * n + 1];
  }
  float col[3];
  for (int k = 0; k < 3; ++k)
    col[k] = fmaxf(SH_C0 * sh[(long long)K * 3 * n + k] + 0.5f, 0.0f);

  float4* row = attrs + n * (ATTR_F / 4);
  row[0] = make_float4(mx, my, ca, cb);
  row[1] = make_float4(cc, col[0], col[1], col[2]);
  row[2] = make_float4(opac[n], o.t[2], 0.0f, 0.0f);
  row[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  radius[n] = ok ? rad : 0;
  valid[n] = ok ? 1 : 0;
  mean2d[2 * n] = mx;
  mean2d[2 * n + 1] = my;
  depth[n] = o.t[2];
}

// the torch.minimum / torch.maximum gradient of clamp(r, -lim, lim) to r:
// 1 inside, 1/2 on a tie, 0 outside
__device__ __forceinline__ float clamp_grad(float r, float lim) {
  const float gmin = r < lim ? 1.0f : (r == lim ? 0.5f : 0.0f);
  const float m = fminf(r, lim);
  const float gmax = m > -lim ? 1.0f : (m == -lim ? 0.5f : 0.0f);
  return gmin * gmax;
}

// the sum of v over the block into out (thread 0 .. POSE_F - 1 write),
// in a fixed order
__device__ __forceinline__ void block_sum_pose(double v[POSE_F],
                                               double* out) {
  __shared__ double part[WARPS][POSE_F];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int k = 0; k < POSE_F; ++k) {
    double x = v[k];
    for (int off = 16; off > 0; off /= 2)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) part[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < POSE_F) {
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s += part[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(THREADS) project_bwd_kernel(
    const float* __restrict__ means, const float* __restrict__ scales,
    const float* __restrict__ rots, const float* __restrict__ sh,
    const uint8_t* __restrict__ valid, const float* __restrict__ w2c,
    const float* __restrict__ intr, const float4* __restrict__ g_attrs,
    float* __restrict__ g_means, float* __restrict__ g_scales,
    float* __restrict__ g_rots, float* __restrict__ g_opac,
    float* __restrict__ g_sh, float* __restrict__ g_offset,
    double* __restrict__ pose_part, int N, int K, int H, int W, float sm) {
  const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
  double pose[POSE_F] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (n < N && valid[n] == 0) {
    for (int k = 0; k < 3; ++k) {
      if (g_means) g_means[3 * n + k] = 0.0f;
      if (g_scales) g_scales[3 * n + k] = 0.0f;
    }
    if (g_rots)
      for (int k = 0; k < 4; ++k) g_rots[4 * n + k] = 0.0f;
    if (g_opac) g_opac[n] = 0.0f;
    if (g_sh)
      for (int k = 0; k < 3 * K; ++k) g_sh[(long long)3 * K * n + k] = 0.0f;
    if (g_offset) g_offset[2 * n] = g_offset[2 * n + 1] = 0.0f;
  } else if (n < N) {
    const Camera cam = load_camera(w2c, intr, H, W);
    Row o;
    project_row(cam, means, scales, rots, n, sm, o);
    const float4 G0 = g_attrs[n * (ATTR_F / 4)];
    const float4 G1 = g_attrs[n * (ATTR_F / 4) + 1];
    const float4 G2 = g_attrs[n * (ATTR_F / 4) + 2];
    // lanes: mx, my, conic a, b, c, r, g, b, opacity, depth
    const float gmx = G0.x, gmy = G0.y;
    const float gca = G0.z, gcb = G0.w, gcc = G1.x;

    if (g_offset) {
      g_offset[2 * n] = gmx;
      g_offset[2 * n + 1] = gmy;
    }
    if (g_opac) g_opac[n] = G2.x;
    if (g_sh) {
      const float gcol[3] = {G1.y, G1.z, G1.w};
      const long long base = (long long)3 * K * n;
      for (int k = 0; k < 3; ++k) {
        const float pre = SH_C0 * sh[base + k] + 0.5f;
        g_sh[base + k] = pre >= 0.0f ? gcol[k] * SH_C0 : 0.0f;
      }
      for (int k = 3; k < 3 * K; ++k) g_sh[base + k] = 0.0f;
    }

    // conic = (c, -b, a) / det
    const float g_inv_det = (gca * o.c - gcb * o.b) + gcc * o.a;
    float ga = gcc * o.inv_det, gb = -(gcb * o.inv_det),
          gc = gca * o.inv_det;
    const float g_det = -(g_inv_det * o.inv_det) * o.inv_det;
    ga += g_det * o.c;
    gc += g_det * o.a;
    gb -= 2.0f * o.b * g_det;
    // a = p.p + 0.3, b = p.q, c = q.q + 0.3; p = s P, q = s Q
    float gP[3], gQ[3];
    for (int j = 0; j < 3; ++j) {
      const float gp = 2.0f * ga * o.p[j] + gb * o.q[j];
      const float gq = gb * o.p[j] + 2.0f * gc * o.q[j];
      if (g_scales) g_scales[3 * n + j] = (gp * o.P[j] + gq * o.Q[j]) * sm;
      gP[j] = gp * o.s[j];
      gQ[j] = gq * o.s[j];
    }
    // P_j = sum_i R_ij u_i, Q_j = sum_i R_ij v_i
    float gR[3][3], gu[3], gv[3];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) gR[i][j] = gP[j] * o.u[i] + gQ[j] * o.v[i];
      gu[i] = (o.R[i][0] * gP[0] + o.R[i][1] * gP[1]) + o.R[i][2] * gP[2];
      gv[i] = (o.R[i][0] * gQ[0] + o.R[i][1] * gQ[1]) + o.R[i][2] * gQ[2];
    }
    if (g_rots) {
      float gq4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      quat_to_matrix_vjp(o.rot, gR, gq4);
      for (int k = 0; k < 4; ++k) g_rots[4 * n + k] = gq4[k];
    }
    // u_k = j00 Rc_0k + j02 Rc_2k, v_k = j11 Rc_1k + j12 Rc_2k
    const float g_j00 = (gu[0] * cam.R[0][0] + gu[1] * cam.R[0][1])
                        + gu[2] * cam.R[0][2];
    const float g_j02 = (gu[0] * cam.R[2][0] + gu[1] * cam.R[2][1])
                        + gu[2] * cam.R[2][2];
    const float g_j11 = (gv[0] * cam.R[1][0] + gv[1] * cam.R[1][1])
                        + gv[2] * cam.R[1][2];
    const float g_j12 = (gv[0] * cam.R[2][0] + gv[1] * cam.R[2][1])
                        + gv[2] * cam.R[2][2];
    // j00 = fx / z, j02 = -fx txz / z^2 (j11, j12 alike), mean2d = f t / z
    float g_inv_z = g_j00 * cam.fx + g_j11 * cam.fy;
    const float g_txz = -cam.fx * o.inv_z2 * g_j02;
    const float g_tyz = -cam.fy * o.inv_z2 * g_j12;
    const float g_inv_z2 = -cam.fx * o.txz * g_j02 - cam.fy * o.tyz * g_j12;
    float gt[3];
    gt[0] = gmx * cam.fx * o.inv_z;
    gt[1] = gmy * cam.fy * o.inv_z;
    g_inv_z += gmx * cam.fx * o.t[0] + gmy * cam.fy * o.t[1];
    g_inv_z += 2.0f * o.inv_z * g_inv_z2;
    // txz = clamp(t0 / z, +-limx) z (tyz alike), inv_z = 1 / z
    float g_z = g_txz * o.rc[0] + g_tyz * o.rc[1];
    const float g_r0 = g_txz * o.tzs * clamp_grad(o.r[0], cam.limx);
    const float g_r1 = g_tyz * o.tzs * clamp_grad(o.r[1], cam.limy);
    gt[0] += g_r0 / o.tzs;
    gt[1] += g_r1 / o.tzs;
    g_z -= (g_r0 * o.r[0] + g_r1 * o.r[1]) / o.tzs;
    g_z -= g_inv_z * o.inv_z * o.inv_z;
    gt[2] = G2.y + (fabsf(o.t[2]) < 1e-6f ? 0.0f : g_z);
    // t = m + w tt + v x tt + tc, tt = 2 v x m
    const float qv[3] = {cam.q[0], cam.q[1], cam.q[2]};
    float gtt[3], gm[3];
    cross(gt, qv, gtt);
    for (int k = 0; k < 3; ++k) gtt[k] += cam.q[3] * gt[k];
    cross(gtt, qv, gm);
    if (g_means)
      for (int k = 0; k < 3; ++k) g_means[3 * n + k] = gt[k] + 2.0f * gm[k];

    if (pose_part) {
      // the camera: tc, then q through quat_act and through Rc
      float gq[4], a1[3], a2[3];
      cross(o.tt, gt, a1);
      cross(o.m, gtt, a2);
      for (int k = 0; k < 3; ++k) gq[k] = a1[k] + 2.0f * a2[k];
      gq[3] = (gt[0] * o.tt[0] + gt[1] * o.tt[1]) + gt[2] * o.tt[2];
      float gRc[3][3];
      for (int k = 0; k < 3; ++k) {
        gRc[0][k] = gu[k] * o.j00;
        gRc[1][k] = gv[k] * o.j11;
        gRc[2][k] = gu[k] * o.j02 + gv[k] * o.j12;
      }
      quat_to_matrix_vjp(cam.q, gRc, gq);
      for (int k = 0; k < 3; ++k) pose[k] = gt[k];
      for (int k = 0; k < 4; ++k) pose[3 + k] = gq[k];
    }
  }
  if (pose_part) block_sum_pose(pose, pose_part + (long long)blockIdx.x *
                                                      POSE_F);
}

// out[k] = sum over blocks of part[b, k], in a fixed order; one block
__global__ void __launch_bounds__(THREADS) pose_sum_kernel(
    const double* __restrict__ part, int n_blocks, float* __restrict__ out) {
  double v[POSE_F] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < n_blocks; b += THREADS)
    for (int k = 0; k < POSE_F; ++k) v[k] += part[(long long)b * POSE_F + k];
  __shared__ double total[POSE_F];
  block_sum_pose(v, total);
  __syncthreads();
  if (threadIdx.x < POSE_F) out[threadIdx.x] = (float)total[threadIdx.x];
}

int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// P1. means, scales (N, 3), rots (N, 4) xyzw, opac (N,), sh (N, K, 3),
// alive (N,) bytes or null, offset (N, 2) or null, w2c (7,), intr (4,) ->
// attrs (N, 16) (16-byte aligned), radius (N,) int32, valid (N,) bytes,
// mean2d (N, 2), depth (N,).
extern "C" int project_fwd(const float* means, const float* scales,
                           const float* rots, const float* opac,
                           const float* sh, const uint8_t* alive,
                           const float* offset, const float* w2c,
                           const float* intr, float* attrs, int* radius,
                           uint8_t* valid, float* mean2d, float* depth, int N,
                           int K, int H, int W, float scale_modifier,
                           float near, void* stream) {
  if (N > 0) {
    project_fwd_kernel<<<blocks_for(N), THREADS, 0, (cudaStream_t)stream>>>(
        means, scales, rots, opac, sh, alive, offset, w2c, intr,
        reinterpret_cast<float4*>(attrs), radius, valid, mean2d, depth, N, K,
        H, W, scale_modifier, near);
  }
  return (int)cudaGetLastError();
}

// P2. The forward's inputs, its valid mask and the cotangent g_attrs (N, 16)
// (16-byte aligned) -> the gradients (any may be null: not written). With
// pose_part (blocks_for(N) x 7 doubles) and g_w2c (7,) given, also the
// camera's gradient, by a second launch.
extern "C" int project_bwd(const float* means, const float* scales,
                           const float* rots, const float* sh,
                           const uint8_t* valid, const float* w2c,
                           const float* intr, const float* g_attrs,
                           float* g_means, float* g_scales, float* g_rots,
                           float* g_opac, float* g_sh, float* g_offset,
                           double* pose_part, float* g_w2c, int N, int K,
                           int H, int W, float scale_modifier, void* stream) {
  if (N > 0) {
    project_bwd_kernel<<<blocks_for(N), THREADS, 0, (cudaStream_t)stream>>>(
        means, scales, rots, sh, valid, w2c, intr,
        reinterpret_cast<const float4*>(g_attrs), g_means, g_scales, g_rots,
        g_opac, g_sh, g_offset, g_w2c ? pose_part : nullptr, N, K, H, W,
        scale_modifier);
  }
  if (g_w2c != nullptr) {
    pose_sum_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
        pose_part, blocks_for(N), g_w2c);
  }
  return (int)cudaGetLastError();
}
