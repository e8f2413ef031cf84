// K1: fused front-to-back tile compositing, forward.
//
// Replaces the Pallas kernel `_fwd_kernel` / `_fwd_one_tile` of
// wildgs_slam_tpu/ops/rasterizer/pallas_composite.py (launched from
// `_fwd_impl`). The semantics are that kernel's, line for line:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, op e^power),
//   dead = power > 0 | alpha < 1/255 | slot >= count,
//   one_m = max(1 - alpha, 0.01),  t_after = T_chunk_entry * prod(one_m),
//   t_before = t_after / one_m (a division, as there),
//   w = alpha t_before [t_after >= 1e-4],
//   T_fin = smallest committed t_after, else the running T.
// `tentry` (the transmittance entering each chunk) is written for every
// chunk, skipped ones included, so the backward never re-runs the prefix.
//
// Design: one block per 16x16 tile, one thread per pixel. Each chunk of `ck`
// packed (16-float) rows is staged in shared memory with float4 loads, and
// each thread walks it sequentially. The block leaves the chunk loop's work
// once no pixel of the tile has T >= 1e-4 (it still writes `tentry`).
//
// Bound on the H100: the operations. Per live (slot, pixel) pair it does
// ~30 fp32 operations and one exp, against ~64 bytes of attributes per slot
// shared by 256 pixels, so the card's fp32 rate and not its memory is the
// limit. The source is compiled with --fmad=false so that it rounds op by op
// as its plain PyTorch version does. Later work: tensor-core (`wgmma`)
// formulations of the per-chunk sums, TMA staging of the chunk rows, more
// tiles per block for occupancy, and atomics to fuse per-Gaussian counts
// (the covisibility render's n_touched) into this pass.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;
constexpr int ATTR_F = 16;
constexpr int MAX_CK = 64;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float ONE_M_MIN = 0.01f;

// packed lanes: mx, my, conic a, b, c, r, g, b, opacity, depth, 6 pad
constexpr int A_MX = 0, A_MY = 1, A_CA = 2, A_CB = 3, A_CC = 4;
constexpr int A_R = 5, A_G = 6, A_B = 7, A_OP = 8, A_D = 9;

__global__ void __launch_bounds__(P) composite_fwd_kernel(
    const int* __restrict__ counts, const int* __restrict__ tile_ids,
    const float* __restrict__ attrs, const float* __restrict__ bg,
    float* __restrict__ color, float* __restrict__ depth,
    float* __restrict__ alpha_out, float* __restrict__ tfin,
    float* __restrict__ tentry, int K, int ck, int tw) {
  __shared__ float4 blk4[MAX_CK * ATTR_F / 4];
  const float* blk = reinterpret_cast<const float*>(blk4);

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int count = counts[t];
  const int tid = tile_ids[t];
  const float px = (float)((tid % tw) * TILE + p % TILE);
  const float py = (float)((tid / tw) * TILE + p / TILE);
  const int n_chunks = K / ck;
  const int vec_per_chunk = ck * ATTR_F / 4;
  const float4* src4 =
      reinterpret_cast<const float4*>(attrs + (size_t)t * K * ATTR_F);

  float T = 1.f, Tc = INFINITY;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f, acc_a = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    tentry[((size_t)t * n_chunks + c) * P + p] = T;
    // block-wide: doubles as the barrier that protects `blk` from being
    // overwritten while another thread still reads the previous chunk
    const int open = __syncthreads_or(T >= T_EPS);
    if (c * ck >= count || !open) continue;  // uniform over the block

    for (int i = p; i < vec_per_chunk; i += P)
      blk4[i] = src4[(size_t)c * vec_per_chunk + i];
    __syncthreads();

    float t_in = 1.f, t_after = T;
    float s_r = 0.f, s_g = 0.f, s_b = 0.f, s_d = 0.f, s_a = 0.f;
    for (int k = 0; k < ck; ++k) {
      const float* g = blk + k * ATTR_F;
      const float dx = g[A_MX] - px;
      const float dy = g[A_MY] - py;
      const float power =
          -0.5f * (g[A_CA] * dx * dx + g[A_CC] * dy * dy) - g[A_CB] * dx * dy;
      const float raw = g[A_OP] * expf(power);
      float a = fminf(0.99f, raw);
      if (power > 0.f || a < ALPHA_MIN || c * ck + k >= count) a = 0.f;
      const float one_m = fmaxf(1.f - a, ONE_M_MIN);
      t_in = t_in * one_m;
      t_after = T * t_in;
      const float t_before = t_after / one_m;
      const bool contrib = t_after >= T_EPS;
      const float w = a * t_before * (contrib ? 1.f : 0.f);
      s_r += w * g[A_R];
      s_g += w * g[A_G];
      s_b += w * g[A_B];
      s_d += w * g[A_D];
      s_a += w;
      if (contrib) Tc = fminf(Tc, t_after);
    }
    acc_r += s_r;
    acc_g += s_g;
    acc_b += s_b;
    acc_d += s_d;
    acc_a += s_a;
    T = t_after;
  }

  const float Tf = isinf(Tc) ? T : Tc;
  const size_t o = (size_t)t * P + p;
  color[o * 3 + 0] = acc_r + Tf * bg[0];
  color[o * 3 + 1] = acc_g + Tf * bg[1];
  color[o * 3 + 2] = acc_b + Tf * bg[2];
  depth[o] = acc_d;
  alpha_out[o] = acc_a;
  tfin[o] = Tf;
}

}  // namespace

extern "C" int composite_fwd(const int* counts, const int* tile_ids,
                             const float* attrs, const float* bg, float* color,
                             float* depth, float* alpha, float* tfin,
                             float* tentry, int T, int K, int ck, int tw,
                             void* stream) {
  if (T > 0) {
    composite_fwd_kernel<<<T, P, 0, (cudaStream_t)stream>>>(
        counts, tile_ids, attrs, bg, color, depth, alpha, tfin, tentry, K, ck,
        tw);
  }
  return (int)cudaGetLastError();
}
