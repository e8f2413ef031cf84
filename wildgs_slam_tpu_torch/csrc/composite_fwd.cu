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
// Bound on the H100: the operations. Every live (slot, pixel) pair of an open
// chunk needs its geometry (~15 fp32 operations with the exp), and only the
// pairs that are alive (12% on the mapping table) need the blend (~15 more),
// against 64 bytes of attributes per slot shared by 256 pixels: 0.0127 ms on
// the mapping table (T=768, K=512), by the card's fp32 rate, not its memory.
//
// Design: one block per 16x16 tile, one thread per pixel, walking the tile's
// chunks of `ck` packed (16-float) rows front to back.
//  - A dead pair stops right after its geometry: it does no division, no
//    transmittance update and no sums. That is exact on finite tables: a
//    dead slot has one_m = 1 and w = 0, so t_in, t_after and the sums stay
//    bit for bit as they were, and the T_fin candidate it would submit is
//    the t_after that the nearest earlier slot that is not dead submitted
//    already (or 1.0, which the first slot that is not dead undercuts, and
//    which is T_fin anyway when every slot is dead). A pair past saturation
//    (t_after < 1e-4) keeps its transmittance product and adds no sums.
//  - Pairs whose exponent lies below log(ALPHA_MIN / op) by more than
//    EXP_SKIP_MARGIN are dead without their exp: op e^power < 1/255 holds
//    with a margin of 1e-3 relative, where expf, logf and the division err
//    by a few 1e-7 relative (logf's absolute error below 1e-5 for any float
//    threshold), so no pair that the plain version finds alive is skipped.
//    The thresholds (one logf per slot) are computed by the block once per
//    chunk, after the rows land.
//  - Shared-memory reads per pair: mx, my, a, b as one float4, c and the
//    threshold as words; (op, depth) as one float2 only past the threshold
//    test, and (c, r, g, b) as one float4 only for a pair that adds weight.
//  - Rows are staged by one thread with `cp.async.bulk` (a 1-D bulk copy,
//    no tensor map) completing on an mbarrier, into two 4 KB buffers: chunk
//    c+1 is in flight while chunk c is walked. A chunk is copied only up to
//    the tile's count, and the slot loop of the last chunk ends there.
//    Staging by every thread, then a barrier, measured slower with the
//    exponent test (and faster without it; PERF.md, Findings).
//  - The block stops walking once no pixel of the tile has T >= 1e-4 (it
//    still writes `tentry`); a prefetched chunk it does not open is waited
//    for before the block exits and never read.
//  - ptxas gives it 39 registers and 8.3 KB of shared memory, so 6 blocks
//    fit on an SM and the mapping table's 768 tiles run in one wave.
// The source is compiled with --fmad=false so that it rounds op by op as its
// plain PyTorch version does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;
constexpr int ATTR_F = 16;
constexpr int VEC = ATTR_F / 4;          // float4 per packed row
constexpr int MAX_CK = 64;
constexpr int ROW_BYTES = ATTR_F * 4;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float ONE_M_MIN = 0.01f;
constexpr float EXP_SKIP_MARGIN = 1e-3f;

// packed row as float4s: (mx, my, conic a, b), (conic c, r, g, b),
// (opacity, depth, pad, pad), (pad x 4)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// One thread: arm `bar` for `bytes` and start the copy global -> shared.
// `bytes` is a multiple of 16 and both addresses are 16-byte aligned.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__global__ void __launch_bounds__(P) composite_fwd_kernel(
    const int* __restrict__ counts, const int* __restrict__ tile_ids,
    const float* __restrict__ attrs, const float* __restrict__ bg,
    float* __restrict__ color, float* __restrict__ depth,
    float* __restrict__ alpha_out, float* __restrict__ tfin,
    float* __restrict__ tentry, int K, int ck, int tw) {
  __shared__ __align__(16) float4 rows[2][MAX_CK * VEC];
  __shared__ float thr[MAX_CK];
  __shared__ __align__(8) uint64_t bars[2];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int count = min(counts[t], K);   // a count past K reads K slots
  const int tid = tile_ids[t];
  const float px = (float)((tid % tw) * TILE + p % TILE);
  const float py = (float)((tid / tw) * TILE + p / TILE);
  const int n_chunks = K / ck;
  const float* tile_rows = attrs + (size_t)t * K * ATTR_F;
  float* tentry_t = tentry + (size_t)t * n_chunks * P + p;

  // chunk c's rows up to the count, into buffer c % 2 (thread 0 only)
  auto stage = [&](int c) {
    const int n = min(ck, count - c * ck);
    bulk_load(rows[c & 1], tile_rows + (size_t)c * ck * ATTR_F,
              (uint32_t)(n * ROW_BYTES), &bars[c & 1]);
  };
  if (p == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (count > 0) stage(0);
  }

  float T = 1.f, Tc = INFINITY;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f, acc_a = 0.f;

  int c = 0;
  for (; c < n_chunks; ++c) {
    tentry_t[(size_t)c * P] = T;
    // block-wide: every thread has left chunk c-1, so buffer (c+1) % 2 and
    // `thr` are free; uniform over the block
    const int open = __syncthreads_or(T >= T_EPS);
    if (c * ck >= count || !open) break;
    const int n = min(ck, count - c * ck);
    const float4* blk = rows[c & 1];
    if (p == 0 && (c + 1) * ck < count) stage(c + 1);
    mbar_wait(&bars[c & 1], (c >> 1) & 1);
    if (p < n) {
      const float op = reinterpret_cast<const float*>(blk + p * VEC + 2)[0];
      // op <= 0: every pair dead; a NaN op skips nothing
      thr[p] = op <= 0.f ? INFINITY : logf(ALPHA_MIN / op) - EXP_SKIP_MARGIN;
    }
    __syncthreads();

    float t_in = 1.f, t_after = T;
    float s_r = 0.f, s_g = 0.f, s_b = 0.f, s_d = 0.f, s_a = 0.f;
    for (int k = 0; k < n; ++k) {
      const float4 g0 = blk[k * VEC];        // mx, my, a, b
      const float cc = reinterpret_cast<const float*>(blk + k * VEC + 1)[0];
      const float dx = g0.x - px;
      const float dy = g0.y - py;
      const float power =
          -0.5f * (g0.z * dx * dx + cc * dy * dy) - g0.w * dx * dy;
      if (power < thr[k]) continue;                         // dead
      const float2 g2 = reinterpret_cast<const float2*>(blk + k * VEC + 2)[0];
      const float a = fminf(0.99f, g2.x * expf(power));
      if (power > 0.f || a < ALPHA_MIN) continue;           // dead
      const float one_m = fmaxf(1.f - a, ONE_M_MIN);
      t_in = t_in * one_m;
      t_after = T * t_in;
      if (!(t_after >= T_EPS)) continue;                    // no weight
      const float4 g1 = blk[k * VEC + 1];    // c, r, g, b
      const float w = a * (t_after / one_m);
      s_r += w * g1.y;
      s_g += w * g1.z;
      s_b += w * g1.w;
      s_d += w * g2.y;
      s_a += w;
      Tc = fminf(Tc, t_after);
    }
    acc_r += s_r;
    acc_g += s_g;
    acc_b += s_b;
    acc_d += s_d;
    acc_a += s_a;
    T = t_after;
  }
  // the chunks left unopened enter with the last T
  for (int c2 = c + 1; c2 < n_chunks; ++c2) tentry_t[(size_t)c2 * P] = T;
  // a chunk prefetched but not opened: its copy lands before the block exits
  if (p == 0 && c < n_chunks && c * ck < count)
    mbar_wait(&bars[c & 1], (c >> 1) & 1);

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
