// K2: fused tile compositing, backward (per-slot analytic gradient).
//
// Replaces the Pallas kernel `_bwd_kernel` / `_bwd_one_tile` of
// wildgs_slam_tpu/ops/rasterizer/pallas_composite.py (launched from
// `_vjp_bwd`, wired by the `_composite_vjp` custom VJP). With
//   g_k = r_k gc_r + g_k gc_g + b_k gc_b + d_k gd + ga,
//   S_k = sum_{j>k} w_j g_j,   B = T_fin (bg . gc + gT),
// it writes, per table slot,
//   dL/dalpha_k = t_before_k g_k [contrib] - (S_k + B [contrib]) / one_m_k,
// zeroed where the slot is dead or raw opacity*G >= 0.99 (the gradient of
// JAX's min, not the Inria rasterizer's), and from it the 10 gradients
// dmx, dmy, d conic a/b/c, d rgb, d opacity, d depth. Lanes 10-15 are 0;
// slots past `count` and chunks the tile never reaches are written as 0.
// The bg gradient is taken outside the kernel, as in JAX.
//
// Design: one block per tile, one thread per pixel, chunks walked back to
// front. The suffix S of later chunks is a register per pixel; inside a
// chunk the slots are walked forward twice, first for the chunk total of
// w g, then with the running prefix, S_k = (total - prefix_k) + S, which is
// exactly the JAX kernel's formula. Each slot's 10 gradients are summed
// over the tile's 256 pixels by warp shuffles, then across the 8 warps
// through shared memory, once per chunk.
//
// Bound on the H100: the operations (~70 fp32 operations and one exp per
// live slot-pixel pair, the forward's geometry done twice, plus the
// reductions), well above the bytes it moves. Compiled with --fmad=false to
// round as the plain PyTorch version does. Later work: fusing the table's
// scatter into per-Gaussian rows as atomics, tensor-core (`wgmma`) forms of
// the pixel reductions, and TMA staging of the chunk rows.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;
constexpr int NWARP = P / 32;
constexpr int ATTR_F = 16;
constexpr int NGRAD = 10;
constexpr int MAX_CK = 64;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float ONE_M_MIN = 0.01f;

constexpr int A_MX = 0, A_MY = 1, A_CA = 2, A_CB = 3, A_CC = 4;
constexpr int A_R = 5, A_G = 6, A_B = 7, A_OP = 8, A_D = 9;

struct Slot {
  float dx, dy, G, raw, a, one_m;
  bool dead;
};

__device__ __forceinline__ Slot geometry(const float* g, bool live, float px,
                                         float py) {
  Slot s;
  s.dx = g[A_MX] - px;
  s.dy = g[A_MY] - py;
  const float power = -0.5f * (g[A_CA] * s.dx * s.dx + g[A_CC] * s.dy * s.dy)
                      - g[A_CB] * s.dx * s.dy;
  s.G = expf(power);
  s.raw = g[A_OP] * s.G;
  s.a = fminf(0.99f, s.raw);
  s.dead = power > 0.f || s.a < ALPHA_MIN || !live;
  if (s.dead) s.a = 0.f;
  s.one_m = fmaxf(1.f - s.a, ONE_M_MIN);
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(P) composite_bwd_kernel(
    const int* __restrict__ counts, const int* __restrict__ tile_ids,
    const float* __restrict__ attrs, const float* __restrict__ bg,
    const float* __restrict__ tentry, const float* __restrict__ tfin,
    const float* __restrict__ gc, const float* __restrict__ gd,
    const float* __restrict__ ga, const float* __restrict__ gt,
    float* __restrict__ dattrs, int K, int ck, int tw) {
  __shared__ float4 blk4[MAX_CK * ATTR_F / 4];
  __shared__ float red[NWARP][MAX_CK][NGRAD];
  const float* blk = reinterpret_cast<const float*>(blk4);

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const int count = counts[t];
  const int tid = tile_ids[t];
  const float px = (float)((tid % tw) * TILE + p % TILE);
  const float py = (float)((tid / tw) * TILE + p / TILE);
  const int n_chunks = K / ck;
  const int vec_per_chunk = ck * ATTR_F / 4;
  const float4* src4 =
      reinterpret_cast<const float4*>(attrs + (size_t)t * K * ATTR_F);
  float* out = dattrs + (size_t)t * K * ATTR_F;

  const size_t o = (size_t)t * P + p;
  const float gcr = gc[o * 3 + 0], gcg = gc[o * 3 + 1], gcb = gc[o * 3 + 2];
  const float gdv = gd[o], gav = ga[o];
  const float B = tfin[o] * (bg[0] * gcr + bg[1] * gcg + bg[2] * gcb + gt[o]);

  float S = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    if (c * ck >= count) {  // uniform over the block
      for (int i = p; i < ck * ATTR_F; i += P) out[c * ck * ATTR_F + i] = 0.f;
      continue;
    }
    __syncthreads();  // previous chunk's readers of blk / red are done
    for (int i = p; i < vec_per_chunk; i += P)
      blk4[i] = src4[(size_t)c * vec_per_chunk + i];
    __syncthreads();

    const float T0 = tentry[((size_t)t * n_chunks + c) * P + p];

    // pass 1: the chunk's total of w g
    float total = 0.f, t_in = 1.f;
    for (int k = 0; k < ck; ++k) {
      const float* g = blk + k * ATTR_F;
      const Slot s = geometry(g, c * ck + k < count, px, py);
      t_in = t_in * s.one_m;
      const float t_after = T0 * t_in;
      const float t_before = t_after / s.one_m;
      const float contrib = t_after >= T_EPS ? 1.f : 0.f;
      const float w = s.a * t_before * contrib;
      const float gsc =
          g[A_R] * gcr + g[A_G] * gcg + g[A_B] * gcb + g[A_D] * gdv + gav;
      total += w * gsc;
    }

    // pass 2: per-slot gradients with S_k = (total - prefix_k) + S
    float pref = 0.f;
    t_in = 1.f;
    for (int k = 0; k < ck; ++k) {
      const float* g = blk + k * ATTR_F;
      const Slot s = geometry(g, c * ck + k < count, px, py);
      t_in = t_in * s.one_m;
      const float t_after = T0 * t_in;
      const float t_before = t_after / s.one_m;
      const float contrib = t_after >= T_EPS ? 1.f : 0.f;
      const float w = s.a * t_before * contrib;
      const float gsc =
          g[A_R] * gcr + g[A_G] * gcg + g[A_B] * gcb + g[A_D] * gdv + gav;
      pref += w * gsc;
      const float S_k = (total - pref) + S;
      float dalpha = t_before * gsc * contrib - (S_k + B * contrib) / s.one_m;
      if (s.dead || s.raw >= 0.99f) dalpha = 0.f;
      const float dpow = dalpha * g[A_OP] * s.G;

      float v[NGRAD];
      v[0] = dpow * -(g[A_CA] * s.dx + g[A_CB] * s.dy);  // d mx
      v[1] = dpow * -(g[A_CC] * s.dy + g[A_CB] * s.dx);  // d my
      v[2] = dpow * s.dx * s.dx;  // d conic a, times -0.5 after the sum
      v[3] = dpow * s.dx * s.dy;  // d conic b, negated after the sum
      v[4] = dpow * s.dy * s.dy;  // d conic c, times -0.5 after the sum
      v[5] = w * gcr;
      v[6] = w * gcg;
      v[7] = w * gcb;
      v[8] = dalpha * s.G;        // d opacity
      v[9] = w * gdv;             // d depth
#pragma unroll
      for (int j = 0; j < NGRAD; ++j) {
        const float r = warp_sum(v[j]);
        if (lane == 0) red[warp][k][j] = r;
      }
    }
    S += total;
    __syncthreads();

    for (int i = p; i < ck * ATTR_F; i += P) {
      const int k = i / ATTR_F, j = i % ATTR_F;
      float r = 0.f;
      if (j < NGRAD) {
#pragma unroll
        for (int wi = 0; wi < NWARP; ++wi) r += red[wi][k][j];
        if (j == 2 || j == 4) r *= -0.5f;
        else if (j == 3) r = -r;
      }
      out[(c * ck + k) * ATTR_F + j] = r;
    }
  }
}

}  // namespace

extern "C" int composite_bwd(const int* counts, const int* tile_ids,
                             const float* attrs, const float* bg,
                             const float* tentry, const float* tfin,
                             const float* gc, const float* gd, const float* ga,
                             const float* gt, float* dattrs, int T, int K,
                             int ck, int tw, void* stream) {
  if (T > 0) {
    composite_bwd_kernel<<<T, P, 0, (cudaStream_t)stream>>>(
        counts, tile_ids, attrs, bg, tentry, tfin, gc, gd, ga, gt, dattrs, K,
        ck, tw);
  }
  return (int)cudaGetLastError();
}
