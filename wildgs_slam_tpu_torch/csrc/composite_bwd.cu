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
// Bound on the H100: the operations. Every live (slot, pixel) pair of an
// open chunk needs the geometry that finds it dead or alive (~15 fp32
// operations, the exp counted as one); each alive pair (alpha >= 1/255 and
// t_after >= 1e-4, about 12% of them on the mapping table) ~55 more for g,
// the suffix, dalpha, the 10 gradients and their sums. The bytes (the live
// table rows, per-pixel inputs, `tentry` and `dattrs`) weigh less.
//
// Design: two kernels on a (tile, chunk) grid of 256-thread blocks, one
// thread per pixel, so that a tile's chunks run in parallel and not one
// after another. In both, a dead slot (alpha 0, so one_m = 1 and w = 0)
// costs only the geometry that finds it dead.
//  1. `chunk_totals` walks a chunk below `count` once and writes each
//     pixel's chunk total of w g into `totals` (T, K/ck, 256), scratch that
//     the wrapper allocates. A pixel stops at its first t_after < 1e-4
//     (every later slot adds an exact 0); a chunk that every pixel enters
//     saturated writes 0 without reading its rows.
//  2. `chunk_grads` sums the later chunks' totals into the suffix S, last
//     chunk first as the plain version does, then walks its chunk once
//     with the running prefix, S_k = (total - prefix_k) + S, which is the
//     JAX kernel's formula. Per slot, a warp none of whose pixels has a
//     nonzero dalpha or w (`__any_sync`) adds an exact 0 and skips its
//     reduction; otherwise the 10 gradients are summed over the warp by a
//     reduce-scatter (12 shuffles, not 10 x 5), and across the 8 warps
//     through shared memory. A warp leaves the walk once all its pixels
//     have t_after < 1e-4 and S == 0: from there every slot has
//     contrib = 0, prefix = total and so dalpha = w = 0 exactly. A chunk
//     at or past `count`, or one every pixel enters with t < 1e-4 and
//     S == 0, writes zeros.
// Compiled with --fmad=false to round as the plain PyTorch version does;
// both kernels form w g with the same operations, so total - prefix is 0
// exactly past a pixel's saturation. Later work: `wgmma` forms of the pixel
// reductions, TMA staging of the chunk rows, and fusing K4's scatter into
// the epilogue.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;
constexpr int NWARP = P / 32;
constexpr int ATTR_F = 16;
constexpr int NGRAD = 10;
constexpr int MAX_CK = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float ONE_M_MIN = 0.01f;

// lanes 0-9 of a packed row: mean, conic a/b/c, rgb, opacity, depth
struct Gauss {
  float mx, my, ca, cb, cc, r, g, b, op, d;
};

// slot k of the staged chunk, in three 16-byte shared-memory loads
__device__ __forceinline__ Gauss load_slot(const float4* blk4, int k) {
  const float4 u = blk4[k * 4], v = blk4[k * 4 + 1], w = blk4[k * 4 + 2];
  return {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w, w.x, w.y};
}

struct Slot {
  float dx, dy, G, raw, a;
  bool dead;
};

// the geometry of a live slot at pixel (px, py). A dead slot has alpha 0,
// so one_m = 1: it leaves the transmittance, w, the prefix and dalpha as
// they are (exact zeros), and both kernels skip the rest of its work.
__device__ __forceinline__ Slot geometry(const Gauss& g, float px, float py) {
  Slot s;
  s.dx = g.mx - px;
  s.dy = g.my - py;
  const float power = -0.5f * (g.ca * s.dx * s.dx + g.cc * s.dy * s.dy)
                      - g.cb * s.dx * s.dy;
  s.G = expf(power);
  s.raw = g.op * s.G;
  s.a = fminf(0.99f, s.raw);
  s.dead = power > 0.f || s.a < ALPHA_MIN;
  return s;
}

// the per-pixel inputs both kernels read
struct Pixel {
  float px, py, gcr, gcg, gcb, gd, ga;
};

__device__ __forceinline__ Pixel pixel(const int* tile_ids, const float* gc,
                                       const float* gd, const float* ga,
                                       int t, int p, int tw) {
  const int tid = tile_ids[t];
  const size_t o = (size_t)t * P + p;
  Pixel q;
  q.px = (float)((tid % tw) * TILE + p % TILE);
  q.py = (float)((tid / tw) * TILE + p / TILE);
  q.gcr = gc[o * 3 + 0];
  q.gcg = gc[o * 3 + 1];
  q.gcb = gc[o * 3 + 2];
  q.gd = gd[o];
  q.ga = ga[o];
  return q;
}

__device__ __forceinline__ float gsc_of(const Gauss& g, const Pixel& q) {
  return g.r * q.gcr + g.g * q.gcg + g.b * q.gcb + g.d * q.gd + q.ga;
}

// chunk c of tile t into shared memory, float4 by float4
__device__ __forceinline__ void stage_chunk(float4* blk4, const float* attrs,
                                            int t, int c, int K, int ck) {
  const float4* src4 = reinterpret_cast<const float4*>(
      attrs + ((size_t)t * K + (size_t)c * ck) * ATTR_F);
  for (int i = threadIdx.x; i < ck * ATTR_F / 4; i += P) blk4[i] = src4[i];
}

__device__ __forceinline__ void zero_chunk(float* out, int ck) {
  for (int i = threadIdx.x; i < ck * ATTR_F; i += P) out[i] = 0.f;
}

// One step of a warp's reduce-scatter of v[0..N): lanes with bit O set keep
// the upper (N+1)/2 values, the others the lower, and each adds its
// partner's copy of the half it keeps (a missing upper value is 0).
template <int N, int O>
__device__ __forceinline__ void halve(float* v, bool up) {
  constexpr int H = (N + 1) / 2;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i];
    const float hi = i + H < N ? v[i + H] : 0.f;
    const float got = __shfl_xor_sync(FULL, up ? lo : hi, O);
    v[i] = (up ? hi : lo) + got;
  }
}

// Which of the NGRAD warp sums lane ends up holding after the reduce-scatter
// of `chunk_grads` (halving 10 -> 5 -> 3 -> 2 -> 1 over lane bits 4..1, then
// bit 0), or -1 for a lane that holds padding or the duplicate at bit 0.
__device__ __forceinline__ int scatter_slot(int lane) {
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1;
  const int b2 = (lane >> 2) & 1, b1 = (lane >> 1) & 1;
  const int local = 2 * b2 + b1;           // position in the 3 or 2 values
  const bool real = b3 ? local < 2 : local < 3;
  return (lane & 1) == 0 && real ? 5 * b4 + 3 * b3 + local : -1;
}

__global__ void __launch_bounds__(P) chunk_totals_kernel(
    const int* __restrict__ counts, const int* __restrict__ tile_ids,
    const float* __restrict__ attrs, const float* __restrict__ tentry,
    const float* __restrict__ gc, const float* __restrict__ gd,
    const float* __restrict__ ga, float* __restrict__ totals, int K, int ck,
    int tw) {
  __shared__ float4 blk4[MAX_CK * ATTR_F / 4];

  const int n_chunks = K / ck;
  const int t = blockIdx.x / n_chunks, c = blockIdx.x % n_chunks;
  const int p = threadIdx.x;
  const int count = counts[t];
  if (c * ck >= count) return;  // uniform; chunk_grads reads no such total
  const size_t tc = ((size_t)t * n_chunks + c) * P + p;
  const float T0 = tentry[tc];
  if (!__syncthreads_or(T0 >= T_EPS)) {
    totals[tc] = 0.f;
    return;
  }
  stage_chunk(blk4, attrs, t, c, K, ck);
  __syncthreads();

  const Pixel q = pixel(tile_ids, gc, gd, ga, t, p, tw);
  const int n_live = min(ck, count - c * ck);
  float total = 0.f, t_in = 1.f;
  for (int k = 0; k < n_live; ++k) {
    const Gauss g = load_slot(blk4, k);
    const Slot s = geometry(g, q.px, q.py);
    if (s.dead) continue;
    const float one_m = fmaxf(1.f - s.a, ONE_M_MIN);
    t_in = t_in * one_m;
    const float t_after = T0 * t_in;
    if (t_after < T_EPS) break;  // w = 0 here and at every later slot
    const float t_before = t_after / one_m;
    const float w = s.a * t_before;  // contrib = 1: chunk_grads' w exactly
    total += w * gsc_of(g, q);
  }
  totals[tc] = total;
}

__global__ void __launch_bounds__(P) chunk_grads_kernel(
    const int* __restrict__ counts, const int* __restrict__ tile_ids,
    const float* __restrict__ attrs, const float* __restrict__ bg,
    const float* __restrict__ tentry, const float* __restrict__ tfin,
    const float* __restrict__ gc, const float* __restrict__ gd,
    const float* __restrict__ ga, const float* __restrict__ gt,
    const float* __restrict__ totals, float* __restrict__ dattrs, int K,
    int ck, int tw) {
  __shared__ float4 blk4[MAX_CK * ATTR_F / 4];
  __shared__ float red[NWARP][MAX_CK][NGRAD];

  const int n_chunks = K / ck;
  const int t = blockIdx.x / n_chunks, c = blockIdx.x % n_chunks;
  const int p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const int count = counts[t];
  float* out = dattrs + ((size_t)t * K + (size_t)c * ck) * ATTR_F;
  if (c * ck >= count) {  // uniform over the block
    zero_chunk(out, ck);
    return;
  }
  const size_t tc = ((size_t)t * n_chunks + c) * P + p;
  const float T0 = tentry[tc];
  // the suffix of the later chunks below count, added last chunk first
  const int n_open = min(n_chunks, (count + ck - 1) / ck);
  float S = 0.f;
  for (int j = n_open - 1; j > c; --j)
    S += totals[((size_t)t * n_chunks + j) * P + p];
  if (!__syncthreads_or(T0 >= T_EPS || S != 0.f)) {
    zero_chunk(out, ck);
    return;
  }
  stage_chunk(blk4, attrs, t, c, K, ck);
  float* red_flat = &red[0][0][0];
  for (int i = p; i < NWARP * MAX_CK * NGRAD; i += P) red_flat[i] = 0.f;
  __syncthreads();

  const Pixel q = pixel(tile_ids, gc, gd, ga, t, p, tw);
  const size_t o = (size_t)t * P + p;
  const float B =
      tfin[o] * (bg[0] * q.gcr + bg[1] * q.gcg + bg[2] * q.gcb + gt[o]);
  const float total = totals[tc];
  const int n_live = min(ck, count - c * ck);
  const int my_j = scatter_slot(lane);
  const bool up4 = lane & 16, up3 = lane & 8, up2 = lane & 4, up1 = lane & 2;

  float pref = 0.f, t_in = 1.f, t_after = T0;
  for (int k = 0; k < n_live; ++k) {
    const Gauss g = load_slot(blk4, k);
    const Slot s = geometry(g, q.px, q.py);
    float dalpha = 0.f, w = 0.f;
    if (!s.dead) {
      const float one_m = fmaxf(1.f - s.a, ONE_M_MIN);
      t_in = t_in * one_m;
      t_after = T0 * t_in;
      const float t_before = t_after / one_m;
      const float contrib = t_after >= T_EPS ? 1.f : 0.f;
      w = s.a * t_before * contrib;
      const float gsc = gsc_of(g, q);
      pref += w * gsc;
      const float S_k = (total - pref) + S;
      dalpha = t_before * gsc * contrib - (S_k + B * contrib) / one_m;
      if (s.raw >= 0.99f) dalpha = 0.f;
    }

    if (__any_sync(FULL, dalpha != 0.f || w != 0.f)) {
      const float dpow = dalpha * g.op * s.G;
      float v[NGRAD];
      v[0] = dpow * -(g.ca * s.dx + g.cb * s.dy);  // d mx
      v[1] = dpow * -(g.cc * s.dy + g.cb * s.dx);  // d my
      v[2] = dpow * s.dx * s.dx;  // d conic a, times -0.5 after the sum
      v[3] = dpow * s.dx * s.dy;  // d conic b, negated after the sum
      v[4] = dpow * s.dy * s.dy;  // d conic c, times -0.5 after the sum
      v[5] = w * q.gcr;
      v[6] = w * q.gcg;
      v[7] = w * q.gcb;
      v[8] = dalpha * s.G;        // d opacity
      v[9] = w * q.gd;            // d depth
      halve<10, 16>(v, up4);
      halve<5, 8>(v, up3);
      halve<3, 4>(v, up2);
      halve<2, 2>(v, up1);
      v[0] += __shfl_xor_sync(FULL, v[0], 1);
      if (my_j >= 0) red[warp][k][my_j] = v[0];
    }
    if (__all_sync(FULL, t_after < T_EPS && S == 0.f)) break;
  }
  __syncthreads();

  for (int i = p; i < ck * ATTR_F; i += P) {
    const int k = i / ATTR_F, j = i % ATTR_F;
    float r = 0.f;
    if (j < NGRAD && k < n_live) {
#pragma unroll
      for (int wi = 0; wi < NWARP; ++wi) r += red[wi][k][j];
      if (j == 2 || j == 4) r *= -0.5f;
      else if (j == 3) r = -r;
    }
    out[i] = r;
  }
}

}  // namespace

extern "C" int composite_bwd(const int* counts, const int* tile_ids,
                             const float* attrs, const float* bg,
                             const float* tentry, const float* tfin,
                             const float* gc, const float* gd, const float* ga,
                             const float* gt, float* totals, float* dattrs,
                             int T, int K, int ck, int tw, void* stream) {
  if (T > 0) {
    const unsigned blocks = (unsigned)T * (unsigned)(K / ck);
    const cudaStream_t s = (cudaStream_t)stream;
    chunk_totals_kernel<<<blocks, P, 0, s>>>(counts, tile_ids, attrs, tentry,
                                             gc, gd, ga, totals, K, ck, tw);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    chunk_grads_kernel<<<blocks, P, 0, s>>>(counts, tile_ids, attrs, bg,
                                            tentry, tfin, gc, gd, ga, gt,
                                            totals, dattrs, K, ck, tw);
  }
  return (int)cudaGetLastError();
}
