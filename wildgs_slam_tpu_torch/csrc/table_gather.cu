// K3 / K4: the tile-table row gather and its scatter-add (the gather's VJP).
//
// K3 `table_gather` replaces the Pallas kernel `_gather_kernel` of
// scripts/microbench_gather.py (launched from `gather_pallas`):
//   out[s, :] = attrs[max(ids[s], 0), :]   for every slot s of a (T, K) table,
// with attrs (N, 16) f32 and ids (T, K) i32. An id of -1 (an empty slot past
// its tile's count) reads row 0, as the port's `gather_table` always has.
//
// K4 `table_scatter_add` replaces `_scatter_kernel` (launched from
// `scatter_pallas`):
//   out = 0;  out[ids[s], :] += g[s, :]   for every slot with ids[s] >= 0.
// Empty slots are skipped. That is exact on the mapping path: the
// composite's backward (K2) writes zero cotangents for dead slots, the
// contract stated for the JAX table gather's custom VJPs, and the plain
// version masks the same slots, so kernel and plain compute one function for
// any g. Clamping -1 to row 0 instead (as `index_add_` on the clamped ids
// does) piles every empty slot's atomics onto one 64-byte row.
//
// Bound on the H100: bytes. Neither kernel does arithmetic beyond the adds,
// so the least time is the bytes moved over 3.35 TB/s: K3 reads the live
// attribute rows and the ids and writes T*K*64 bytes; K4 reads the ids and
// the live slots' cotangents and writes N*64 bytes (the fill and the adds
// write the same rows; the bound counts them once).
//
// Design. K3: one thread per (slot, 4-float lane), 16-byte float4 loads and
// stores, so neighbouring threads touch neighbouring addresses of a row and a
// warp moves 8 whole rows. K4: one thread per (slot, lane) as well; it reads
// its slot's id, exits on an empty slot before touching g, and adds its
// float4 with one 16-byte vector reduction (`atomicAdd(float4*, float4)`,
// global memory, compute capability 9.x; its unused result compiles to
// `REDG.E.ADD.F32x4`), a quarter of the L2 atomic operations of four scalar
// adds. One thread per slot with four float4 loads and four reductions
// measured slower (PERF.md, Findings); its loads stride 64 bytes across a
// warp. The zero fill is a cudaMemsetAsync on the same stream. Later work:
// aggregate equal ids inside a warp so that K4 makes one atomic per
// distinct row, and fuse K4 into K2's epilogue.

#include <cuda_runtime.h>

namespace {

constexpr int ATTR_F = 16;
constexpr int LANES = ATTR_F / 4;   // float4 lanes per row
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) table_gather_kernel(
    const float4* __restrict__ attrs, const int* __restrict__ ids,
    float4* __restrict__ out, long long n_lanes) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_lanes) return;
  const long long s = i / LANES;
  const int lane = (int)(i % LANES);
  const int id = max(ids[s], 0);
  out[i] = attrs[(long long)id * LANES + lane];
}

__global__ void __launch_bounds__(THREADS) table_scatter_add_kernel(
    const float4* __restrict__ g, const int* __restrict__ ids,
    float4* __restrict__ out, long long n_lanes) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_lanes) return;
  const int id = ids[i / LANES];
  if (id < 0) return;
  atomicAdd(out + (long long)id * LANES + (int)(i % LANES), g[i]);
}

int blocks_for(long long n_lanes) {
  return (int)((n_lanes + THREADS - 1) / THREADS);
}

}  // namespace

// attrs (n_rows, 16), ids (n_slots,), out (n_slots, 16); all 16-byte aligned.
extern "C" int table_gather(const float* attrs, const int* ids, float* out,
                            int n_slots, int n_rows, void* stream) {
  (void)n_rows;
  const long long n_lanes = (long long)n_slots * LANES;
  if (n_lanes > 0) {
    table_gather_kernel<<<blocks_for(n_lanes), THREADS, 0,
                          (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(attrs), ids,
        reinterpret_cast<float4*>(out), n_lanes);
  }
  return (int)cudaGetLastError();
}

// g (n_slots, 16), ids (n_slots,), out (n_rows, 16), zeroed here first.
extern "C" int table_scatter_add(const float* g, const int* ids, float* out,
                                 int n_slots, int n_rows, void* stream) {
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)n_rows * ATTR_F * sizeof(float), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const long long n_lanes = (long long)n_slots * LANES;
  if (n_lanes > 0) {
    table_scatter_add_kernel<<<blocks_for(n_lanes), THREADS, 0,
                               (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(g), ids,
        reinterpret_cast<float4*>(out), n_lanes);
  }
  return (int)cudaGetLastError();
}
