// conv_nhwc: the update operator's convolutions (models/droid_net.py,
// UpdateModule, ConvGRU, GraphAgg) as one NHWC, stride-1, "same"-padded,
// float32 implicit-GEMM kernel with fused epilogues.
//
// It replaces no kernel of the JAX package: that package leaves these
// convolutions to XLA (flax `nn.Conv`, `lax.conv_general_dilated`, in
// wildgs_slam_tpu/models/droid_net.py). It was added because cuDNN, with
// TF32 off and at the operator's batch-dependent shapes, picks FFT
// algorithms for the 3x3 convolutions: no arithmetic saved for a 3x3
// filter, the filters transformed again on every call, several launches a
// convolution, and NHWC <-> NCHW conversions around them.
//
// Function. Sources x_0 .. x_{S-1} (NHWC: E images of H x W, channels
// concatenated in that order into C_in), weights w (k, k, C_in, N), pad
// p = k / 2, m = (e, y, x) an output pixel:
//   acc[m, n] = sum_{ty, tx, c} X[e, y + ty - p, x + tx - p, c] w[ty, tx, c, n]
// with X zero outside each image (no pixel of one image reads another's),
// and source 0 multiplied channel by channel by `scale` first where given
// (the GRU's r * net). Epilogue, op by op as the plain version rounds it:
//   v = acc (+ bias[n]) (+ glo[e, n]);  v = act(v)  (none, relu, sigmoid, tanh)
//   MUL:   v = v * aux[m, n]
//   BLEND: v = (1 - gate[m, n]) * aux[m, n] + gate[m, n] * v
//
// Bound on the H100: operations. 2 M N K operations (M = E H W, K = k k
// C_in) against about (M C_in + M N) * 4 bytes: the GRU's z|r launch at
// E = 64 and 48 x 64 does 406 GFLOP (6.06 ms at 67 TFLOP/s fp32) on 0.35 GB
// (0.11 ms at 3.35 TB/s).
//
// Design (float32 products and sums on the CUDA cores; the tensor cores
// take no float32 products):
//  - GEMM view: a block of 256 threads computes a BM x BN output tile, each
//    thread a TM x TN register micro-tile, accumulated with explicit
//    __fmaf_rn. The library is built with --fmad=false (K1/K2's parity),
//    which would otherwise keep every product and sum apart and halve the
//    rate.
//  - The K loop walks slabs of BK = 8: one tap, 8 channels of one source.
//    While the block computes on one slab in shared memory, each thread
//    loads its part of the next into registers: 8 channels of one pixel as
//    two 16-byte loads (one 32-byte sector), or a float4 of weights. Then it
//    stores them into the other of two shared buffers, A transposed to
//    [k][m] (rows padded by 4 floats, so the transposing stores of a warp
//    hit 32 banks). One barrier a slab.
//  - A warp is 4 x 8 threads reading its A and B fragments as float4s
//    (float2s where a thread has 2 rows or columns): at most 128 distinct
//    bytes a read, one shared-memory wavefront each.
//  - Border masks test each tap's pixel against its own image; channels
//    past a source's count (196 = 24 x 8 + 4, the flow's 4) load as zeros,
//    as do weight columns past N (the packed weights are padded to a
//    multiple of 4 columns, so every weight load is a float4).
//  - Tiles 128 x 128 (8 x 8 a thread), 128 x 64 (8 x 4) and 128 x 16 (4 x 2,
//    the 1- and 2-channel heads), by N; and 32 x 128 (2 x 8) and 32 x 64
//    (2 x 4) where 128 rows would leave SMs idle (one edge: M = 3,072 is 24
//    row tiles against 132 SMs). The wrapper (ops/conv_nhwc.py::plan)
//    picks the tile from M, N and the card's SMs. Every tile adds each
//    output's products in one order (slab by slab, channel by channel, one
//    FMA chain), so a batch gives each image what it would get alone: the
//    edge-sharded update gets the single device's numbers. (A split of the
//    K loop would fill the card too, but sums in another order for another
//    batch.)
//  - Blocks walk N fastest, so the blocks that share an A tile run together
//    and its second read comes from L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 8;
constexpr int MAX_SRC = 4;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2, ACT_TANH = 3 };
enum Mode { MODE_PLAIN = 0, MODE_MUL = 1, MODE_BLEND = 2 };

struct Params {
  const float* x[MAX_SRC];   // sources: channels [0, c), pixels `stride` apart
  int c[MAX_SRC];
  int stride[MAX_SRC];
  int n_src, c_in;
  const float* scale;        // multiplier of source 0, or null
  int scale_stride;
  const float* wt;           // (k * k, c_in, n_pad)
  const float* bias;         // (n) or null
  const float* glo;          // (e, glo_stride) or null
  int glo_stride;
  const float* aux;          // MUL: the factor; BLEND: the old state
  int aux_stride;
  const float* gate;         // BLEND: the update gate
  int gate_stride;
  float* out;                // (e * h * w, n)
  int e, h, wd, n, n_pad, k, act, mode;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <int V>
__device__ __forceinline__ void frag(const float* s, float* r) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(s);
    r[0] = v.x; r[1] = v.y;
  }
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(v, 0.0f);
    case ACT_SIGMOID: return 1.0f / (1.0f + expf(-v));
    case ACT_TANH: return tanhf(v);
    default: return v;
  }
}

// The epilogue of output (m, n) of image e, from its sum `t`.
__device__ __forceinline__ float finish(const Params& p, long long m, int e,
                                       int n, float t) {
  if (p.bias != nullptr) t = t + p.bias[n];
  if (p.glo != nullptr) t = t + p.glo[(long long)e * p.glo_stride + n];
  t = activate(t, p.act);
  if (p.mode == MODE_MUL) {
    t = t * p.aux[m * p.aux_stride + n];
  } else if (p.mode == MODE_BLEND) {
    const float z = p.gate[m * p.gate_stride + n];
    t = (1.0f - z) * p.aux[m * p.aux_stride + n] + z * t;
  }
  return t;
}

// The source `s`'s pointer, channels and stride (a constant index into the
// parameters for each candidate, so they stay out of local memory).
__device__ __forceinline__ void pick(const Params& p, int s, const float*& x,
                                     int& c, int& stride) {
  x = p.x[0]; c = p.c[0]; stride = p.stride[0];
#pragma unroll
  for (int j = 1; j < MAX_SRC; ++j)
    if (s == j) { x = p.x[j]; c = p.c[j]; stride = p.stride[j]; }
}

template <int BM, int BN, int TM, int TN, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
conv_nhwc_kernel(const Params p) {
  constexpr int VM = TM < 4 ? TM : 4, VN = TN < 4 ? TN : 4;
  constexpr int RM = TM / VM, RN = TN / VN;    // vector chunks a thread
  constexpr int THR_N = BN / TN;
  static_assert((BM / TM) * THR_N == THREADS, "one micro-tile a thread");
  static_assert(THR_N % 8 == 0 && (BM / TM) % 4 == 0, "4 x 8 thread warps");
  constexpr int AP = BM + 4;                   // A row pitch, floats
  constexpr int A_VEC = 2 * BM;                // float4s of a slab's A tile
  constexpr int B_VEC = BK * BN / 4;           // and of its B tile
  constexpr int LOADS = (A_VEC + B_VEC + THREADS - 1) / THREADS;

  __shared__ __align__(16) float As[2][BK][AP];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tr = (warp / (THR_N / 8)) * 4 + (lane >> 3);
  const int tc = (warp % (THR_N / 8)) * 8 + (lane & 7);

  const int hw = p.h * p.wd;
  const int M = p.e * hw;
  const int n_tiles = (p.n + BN - 1) / BN;
  const int m0 = (int)(blockIdx.x / n_tiles) * BM;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;

  // this thread's A loads: output pixel (index, row, column); -1 past M
  int lm[LOADS], ly[LOADS], lx[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int g = tid + i * THREADS;
    const int m = m0 + (g >> 1);
    lm[i] = (g < A_VEC && m < M) ? m : -1;
    const int r = m % hw;
    ly[i] = r / p.wd;
    lx[i] = r % p.wd;
  }

  int per_tap = 0;
#pragma unroll
  for (int j = 0; j < MAX_SRC; ++j)
    if (j < p.n_src) per_tap += (p.c[j] + BK - 1) / BK;
  const int n_slabs = p.k * p.k * per_tap;
  const int pad = p.k >> 1;

  // the slab being loaded: tap (row ty, column tx; its first weight row
  // trow), source, its first channel there. Offsets fit in 32 bits: the
  // wrapper checks that E H W times every pixel stride does.
  int ty = 0, tx = 0, trow = 0;
  int src = 0, c0 = 0, src_off = 0;
  const float* sx;
  int sc, ss;
  pick(p, 0, sx, sc, ss);

  float4 reg[LOADS];
  auto load = [&]() {
    const int dy = ty - pad, dx = tx - pad, shift = dy * p.wd + dx;
    const int wrow = trow + src_off + c0;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int g = tid + i * THREADS;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (g < A_VEC) {
        const int c = c0 + (g & 1) * 4;
        const int y = ly[i] + dy, x = lx[i] + dx;
        if (lm[i] >= 0 && c < sc && y >= 0 && y < p.h && x >= 0 &&
            x < p.wd) {
          const int pix = lm[i] + shift;
          v = ld4(sx + pix * ss + c);
          if (src == 0 && p.scale != nullptr) {
            const float4 s = ld4(p.scale + pix * p.scale_stride + c);
            v.x *= s.x; v.y *= s.y; v.z *= s.z; v.w *= s.w;
          }
        }
      } else if (g < A_VEC + B_VEC) {
        const int b = g - A_VEC;
        const int row = b / (BN / 4), col = n0 + (b % (BN / 4)) * 4;
        if (c0 + row < sc && col < p.n_pad)
          v = ld4(p.wt + (wrow + row) * p.n_pad + col);
      }
      reg[i] = v;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int g = tid + i * THREADS;
      if (g < A_VEC) {
        const int r = g >> 1, c = (g & 1) * 4;
        As[buf][c + 0][r] = reg[i].x;
        As[buf][c + 1][r] = reg[i].y;
        As[buf][c + 2][r] = reg[i].z;
        As[buf][c + 3][r] = reg[i].w;
      } else if (g < A_VEC + B_VEC) {
        const int b = g - A_VEC;
        *reinterpret_cast<float4*>(&Bs[buf][b / (BN / 4)][(b % (BN / 4)) * 4]) =
            reg[i];
      }
    }
  };
  auto advance = [&]() {
    c0 += BK;
    if (c0 >= sc) {
      c0 = 0;
      src_off += sc;
      if (++src == p.n_src) {
        src = 0;
        src_off = 0;
        trow += p.c_in;
        if (++tx == p.k) {
          tx = 0;
          ++ty;
        }
      }
      pick(p, src, sx, sc, ss);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  if (n_slabs > 0) {
    load();
    store(0);
  }
  __syncthreads();
  for (int s = 0; s < n_slabs; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < n_slabs;
    if (more) {
      advance();
      load();
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int r = 0; r < RM; ++r)
        frag<VM>(&As[buf][kk][r * (BM / RM) + tr * VM], a + r * VM);
#pragma unroll
      for (int r = 0; r < RN; ++r)
        frag<VN>(&Bs[buf][kk][r * (BN / RN) + tc * VN], b + r * VN);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / VM) * (BM / RM) + tr * VM + (i % VM);
    if (m >= M) continue;
    const int e = m / hw;
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int nb = n0 + r * (BN / RN) + tc * VN;
      float v[VN];
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        const float t = acc[i][r * VN + j];
        v[j] = nb + j < p.n ? finish(p, m, e, nb + j, t) : t;
      }
      float* o = p.out + (long long)m * p.n + nb;
      if constexpr (VN == 4) {
        if (nb + 4 <= p.n && (p.n & 3) == 0) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < VN; ++j)
        if (nb + j < p.n) o[j] = v[j];
    }
  }
}

template <int BM, int BN, int TM, int TN, int MIN_BLOCKS>
int launch(const Params& p, cudaStream_t stream) {
  const long long m = (long long)p.e * p.h * p.wd;
  const long long blocks = ((m + BM - 1) / BM) * ((p.n + BN - 1) / BN);
  conv_nhwc_kernel<BM, BN, TM, TN, MIN_BLOCKS><<<(unsigned)blocks, THREADS, 0,
                                                  stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Sources x0..x3 (a null pointer and 0 channels past the last), `scale` of
// source 0 or null, packed weights w (k, k, sum c, n_pad), bias (n) or null,
// glo (e, glo_stride) or null, aux / gate for the epilogue's mode or null;
// out (e, h, w, n). Strides count floats between neighbouring pixels.
// `tile`: 0 = 128 x 128, 1 = 128 x 64, 2 = 128 x 16, 3 = 32 x 128,
// 4 = 32 x 64.
extern "C" int conv_nhwc(
    const float* x0, const float* x1, const float* x2, const float* x3,
    const float* scale, const float* w, const float* bias, const float* glo,
    const float* aux, const float* gate, float* out, int c0,
    int c1, int c2, int c3, int s0, int s1, int s2, int s3, int scale_stride,
    int glo_stride, int aux_stride, int gate_stride, int e, int h, int wd,
    int n, int n_pad, int k, int act, int mode, int tile, void* stream) {
  Params p;
  const float* xs[MAX_SRC] = {x0, x1, x2, x3};
  const int cs[MAX_SRC] = {c0, c1, c2, c3};
  const int ss[MAX_SRC] = {s0, s1, s2, s3};
  p.n_src = 0;
  p.c_in = 0;
  for (int j = 0; j < MAX_SRC; ++j) {
    p.x[j] = xs[j];
    p.c[j] = cs[j];
    p.stride[j] = ss[j];
    if (cs[j] > 0) {
      p.n_src = j + 1;
      p.c_in += cs[j];
    }
  }
  p.scale = scale; p.scale_stride = scale_stride;
  p.wt = w; p.bias = bias;
  p.glo = glo; p.glo_stride = glo_stride;
  p.aux = aux; p.aux_stride = aux_stride;
  p.gate = gate; p.gate_stride = gate_stride;
  p.out = out;
  p.e = e; p.h = h; p.wd = wd; p.n = n; p.n_pad = n_pad; p.k = k;
  p.act = act; p.mode = mode;
  if ((long long)e * h * wd == 0 || n == 0) return 0;
  if (p.n_src == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 0: return launch<128, 128, 8, 8, 2>(p, st);
    case 1: return launch<128, 64, 8, 4, 2>(p, st);
    case 2: return launch<128, 16, 4, 2, 3>(p, st);
    case 3: return launch<32, 128, 2, 8, 3>(p, st);
    case 4: return launch<32, 64, 2, 4, 3>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
