// M1 / M2: the uncertainty-aware mapping loss of slam/losses.py
// (`mapping_loss_uncertainty`) and its backward, as five launches.
//
// It replaces no TPU kernel: in the JAX package this loss is XLA's fusion of
// wildgs_slam_tpu/slam/losses.py::mapping_loss_uncertainty. In the port's
// plain PyTorch version it is ~160 device operations forward (twenty
// depthwise convolutions for the two SSIMs, five antialiased resamples, the
// median pool's pad, stack and sort, ~110 elementwise operations) and ~90
// backward, each a few microseconds of device work behind a host launch: the
// mapping step is bound by the host's launches. Here:
//
// M1 forward, three launches:
//   `loss_fwd_pixel`  one thread per pixel, 32 x 16 pixel tiles with a
//     5-pixel halo in shared memory. Per channel it blurs the five moment
//     maps (x, y, x^2, y^2, x y) of img_ab = exp(a) img + b and gt
//     separably at window 11 (the standard SSIM, which carries the gradient)
//     and at the configured window (<= 11, the clipped luminance, contrast
//     and structure, which carry none), with zero padding at the image edge
//     as F.conv2d(padding=r) pads. It computes every per-pixel term (the
//     masked L1s, the upsampled uncertainty weights, ssim_loss_map, the
//     depth terms), writes l1_rgb, l1_depth, weights_pix and ssim_loss_map,
//     the three coefficient maps per channel of the SSIM mean's gradient
//     (d ssim_map / d mu1, d/d blur(x^2), d/d blur(x y)), and each block's
//     four partial sums.
//   `loss_fwd_down`  one block per (DINO row, map): the four downsamples to
//     the DINO grid (bilinear: ssim_loss_map and opacity; bicubic:
//     min(l1_depth, 5) and the reference depth) as two passes of per-axis
//     weight tables (column sums over the row's taps into shared memory,
//     then the row's taps).
//   `loss_fwd_finish`  one block: the k x k median pool (zero padding, NaN
//     where the window holds one), uncer_loss and its derivative in sigma,
//     and the fixed-order sums of every block's partials into `total`.
// M2 backward, two launches:
//   `loss_bwd_pixel`  the same tiles: blurs the coefficient maps at window
//     11 (the window is symmetric and zero-padded, so the transpose of the
//     blur is the same blur), adds the L1 gradient, scales by the incoming
//     gradient, writes the image's and the depth's gradients and each
//     block's two exposure partials.
//   `loss_bwd_finish`  one block: the exposure gradients (fixed-order sums)
//     and sigma's gradient.
//
// Every sum over blocks is taken in a fixed order, in float64, with no
// atomics: a call repeats bit for bit. The weight tables come from the
// caller (slam/losses_cuda.py), built once per shape by putting an identity
// basis through the same F.interpolate(antialias=True) call that the plain
// resamples make, so the weights are the plain path's; what differs from the
// plain path is the order of the sums.
//
// Bound on the H100: the arithmetic (~2,000 fp32 operations a pixel, mostly
// the two blurs, against ~90 bytes a pixel read and written), so about 6 us
// at 384x512 at 67 TFLOP/s. The design keeps the blurred moment maps in
// shared memory (the plain path writes and reads some thirty full-size maps
// for them) and the halo's reloads in L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;  // pixel tile: one thread a pixel
constexpr int TY = 16;
constexpr int PIX_THREADS = TX * TY;
constexpr int R = 5;  // window 11's radius: the tile's halo
constexpr int WIN = 2 * R + 1;
constexpr int HX = TX + 2 * R;
constexpr int HY = TY + 2 * R;
constexpr int DOWN_THREADS = 256;
constexpr int MAX_W = 2048;  // the downsample's row of column sums
constexpr int FIN_THREADS = 1024;
constexpr int MAX_MEDIAN = 49;  // a 7 x 7 window
constexpr int FWD_PART = 4;  // sum of w l1_rgb, of w, of l1_depth_w, of ssim
constexpr int BWD_PART = 2;  // sum of g_ab img, of g_ab

constexpr float C1 = 1e-4f;     // ops/ssim.py: SSIM_C1 = 0.01 ** 2
constexpr float C2 = 9e-4f;     // SSIM_C2 = 0.03 ** 2
constexpr float C3 = 4.5e-4f;   // SSIM_C3 = SSIM_C2 / 2
constexpr float EPS = 1.1920928955078125e-07f;  // float32 eps
constexpr float MAX_CLIP = 0.98f;
constexpr float DEPTH_MAX_CLIP = 5.0f;
constexpr float SSIM_MAP_CLIP = 5.0f;
constexpr float UNC_MIN = 0.1f;
constexpr float UNC_ADD = 1e-3f;

// a per-axis resampling table: output o reads inputs start[o] .. start[o] +
// taps - 1 with weights w[o * taps ...] (zeros past its span)
struct Axis {
  const int* start;
  const float* w;
  int taps;
};

// torch.clamp's NaN-propagating forms
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float sgn(float x) {  // torch.sign
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}
// torch.minimum: NaN if either is
__device__ __forceinline__ float nan_min(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a < b ? a : b;
}

// the depth threshold: clamp(10 * median, max=50)
__device__ __forceinline__ float depth_threshold(const float* med) {
  return clamp_max(10.0f * med[0], 50.0f);
}

// sum over a block of PIX_THREADS threads of N values each, in a fixed tree
// order; thread 0 writes them to out[0 .. N)
template <int N>
__device__ void block_sum(float (*red)[PIX_THREADS], const float v[N],
                          float* out) {
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int k = 0; k < N; ++k) red[k][tid] = v[k];
  __syncthreads();
  for (int s = PIX_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s)
      for (int k = 0; k < N; ++k) red[k][tid] += red[k][tid + s];
    __syncthreads();
  }
  if (tid < N) out[tid] = red[tid][0];
}

// sum over the FIN_THREADS threads of one block, in a fixed tree order;
// every thread gets the total
__device__ double fin_sum(double v, double* red) {
  __syncthreads();
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = FIN_THREADS / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// the uncertainty sigma on the DINO grid as the loss uses it:
// clamp(sigma, min=0.1) + 1e-3
__device__ __forceinline__ float proc_unc(float s) {
  return clamp_min(s, UNC_MIN) + UNC_ADD;
}

struct FwdArgs {
  const float *img, *depth, *gt, *ref, *sigma, *opac, *exp_a, *exp_b, *med;
  const float* gauss;  // window 11's taps, then the components' window's
  float *l1_rgb, *l1_depth, *weights, *slm, *coef, *part;
  Axis up_y, up_x;  // the DINO grid -> the image
  int H, W, h, w, ws, init, use_ssim;
  float thr_rgb, data_rate, ssim_weight;
};

__global__ void __launch_bounds__(PIX_THREADS)
    loss_fwd_pixel(const FwdArgs a) {
  __shared__ float xs[HY][HX];  // img_ab of one channel, with the halo
  __shared__ float ys[HY][HX];  // gt
  // column sums of the tile's rows: the five moments at window 11, then at
  // the components' window
  __shared__ float vb[10][TY][HX];
  __shared__ float red[FWD_PART][PIX_THREADS];

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int px = x0 + tx, py = y0 + ty;
  const int H = a.H, W = a.W;
  const bool inside = px < W && py < H;
  const long long HW = (long long)H * W;
  const long long p = inside ? (long long)py * W + px : 0;
  const float expa = a.init ? 1.0f : expf(a.exp_a[0]);
  const float eb = a.init ? 0.0f : a.exp_b[0];
  const int rc = a.ws / 2;
  const float* g11 = a.gauss;
  const float* gc = a.gauss + WIN;

  float gsum = 0.0f, m = 0.0f;
  if (inside) {
    gsum = (a.gt[3 * p] + a.gt[3 * p + 1]) + a.gt[3 * p + 2];
    m = gsum > a.thr_rgb ? 1.0f : 0.0f;
  }
  float wl1 = 0.0f, ssim_sum = 0.0f;
  float lum = 0.0f, con = 0.0f, struc = 0.0f;
  float weight = 0.0f;
  if (inside) {
    // the uncertainty weights: sigma upsampled (rows of taps along x first,
    // then along y, as the antialiased resample sums), annealed, inverted
    const int sy = a.up_y.start[py], sx = a.up_x.start[px];
    const float* wy = a.up_y.w + (long long)py * a.up_y.taps;
    const float* wx = a.up_x.w + (long long)px * a.up_x.taps;
    float r = 0.0f;
    for (int i = 0; i < a.up_y.taps; ++i) {
      const float* row = a.sigma + (long long)(sy + i) * a.w + sx;
      float t = 0.0f;
      for (int j = 0; j < a.up_x.taps; ++j) t += wx[j] * proc_unc(row[j]);
      r += wy[i] * t;
    }
    const float ru = (r - UNC_MIN) * a.data_rate + UNC_MIN;
    weight = (1.0f / (ru * ru)) * 0.5f;
    weight = weight < 0.1f ? 0.0f : weight;
    a.weights[p] = weight;
  }

  for (int c = 0; c < 3; ++c) {
    __syncthreads();  // the previous channel's reads of xs, ys, vb are done
    for (int i = tid; i < HY * HX; i += PIX_THREADS) {
      const int r = i / HX, q = i % HX;
      const int yy = y0 - R + r, xx = x0 - R + q;
      float xv = 0.0f, yv = 0.0f;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const long long o = ((long long)yy * W + xx) * 3 + c;
        const float v = a.img[o];
        xv = a.init ? v : expa * v + eb;
        yv = a.gt[o];
      }
      xs[r][q] = xv;
      ys[r][q] = yv;
    }
    __syncthreads();
    for (int i = tid; i < TY * HX; i += PIX_THREADS) {
      const int r = i / HX, q = i % HX;
      float s[10];
      for (int k = 0; k < 10; ++k) s[k] = 0.0f;
      if (a.use_ssim) {
        for (int k = 0; k < WIN; ++k) {
          const float g = g11[k], xv = xs[r + k][q], yv = ys[r + k][q];
          s[0] += g * xv;
          s[1] += g * yv;
          s[2] += g * (xv * xv);
          s[3] += g * (yv * yv);
          s[4] += g * (xv * yv);
        }
      }
      for (int k = 0; k < a.ws; ++k) {
        const float g = gc[k];
        const float xv = xs[r + R - rc + k][q], yv = ys[r + R - rc + k][q];
        s[5] += g * xv;
        s[6] += g * yv;
        s[7] += g * (xv * xv);
        s[8] += g * (yv * yv);
        s[9] += g * (xv * yv);
      }
      for (int k = 0; k < 10; ++k) vb[k][r][q] = s[k];
    }
    __syncthreads();
    if (!inside) continue;

    float b[10];
    for (int k = 0; k < 10; ++k) b[k] = 0.0f;
    if (a.use_ssim) {
      for (int k = 0; k < WIN; ++k) {
        const float g = g11[k];
        for (int n = 0; n < 5; ++n) b[n] += g * vb[n][ty][tx + k];
      }
    }
    for (int k = 0; k < a.ws; ++k) {
      const float g = gc[k];
      for (int n = 5; n < 10; ++n) b[n] += g * vb[n][ty][tx + R - rc + k];
    }
    const float xv = xs[ty + R][tx + R], yv = ys[ty + R][tx + R];

    // the masked L1 of the exposure-compensated render
    const float l1 = fabsf(xv * m - yv * m);
    a.l1_rgb[3 * p + c] = l1;
    wl1 += weight * l1;

    if (a.use_ssim) {
      // ssim(img_ab, gt) at window 11: img1 = img_ab, img2 = gt
      const float mu1 = b[0], mu2 = b[1];
      const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
      const float s1 = b[2] - mu1_sq, s2 = b[3] - mu2_sq;
      const float s12 = b[4] - mu1_mu2;
      const float A1 = 2.0f * mu1_mu2 + C1, A2 = 2.0f * s12 + C2;
      const float B1 = (mu1_sq + mu2_sq) + C1, B2 = (s1 + s2) + C2;
      const float den = B1 * B2;
      const float sm = (A1 * A2) / den;
      ssim_sum += sm;
      // d sm / d mu1 (through mu1, sigma1_sq and sigma12), d sm / d
      // blur(img1^2), d sm / d blur(img1 img2)
      const float c_mu = (2.0f * mu2 * (A2 - A1) - 2.0f * mu1 * sm * (B2 - B1))
                         / den;
      const float c_e11 = -sm / B2;
      const float c_e12 = 2.0f * A1 / den;
      a.coef[(3 * c + 0) * HW + p] = c_mu;
      a.coef[(3 * c + 1) * HW + p] = c_e11;
      a.coef[(3 * c + 2) * HW + p] = c_e12;
    }

    // ssim_components(gt, img_ab): img1 = gt, img2 = img_ab
    {
      const float mu1 = b[6], mu2 = b[5];
      const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
      const float s1sq = clamp_min(b[8] - mu1_sq, EPS);
      const float s2sq = clamp_min(b[7] - mu2_sq, EPS);
      float s12 = b[9] - mu1_mu2;
      s12 = sgn(s12) * nan_min(sqrtf(s1sq * s2sq), fabsf(s12));
      const float sd1 = sqrtf(s1sq), sd2 = sqrtf(s2sq);
      const float lu = (2.0f * mu1_mu2 + C1) / ((mu1_sq + mu2_sq) + C1);
      const float co = (2.0f * sd1 * sd2 + C2) / ((s1sq + s2sq) + C2);
      const float st = (s12 + C3) / (sd1 * sd2 + C3);
      lum += lu;
      con += clamp_max(co, MAX_CLIP);
      struc += clamp_max(st, MAX_CLIP);
    }
  }

  float v[FWD_PART] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (inside) {
    const float third = 1.0f / 3.0f;
    lum *= third;
    con *= third;
    struc *= third;
    const float op = a.opac[p];
    a.slm[p] = clamp_max(
        op * a.ssim_weight * (1.0f - lum) * (1.0f - struc) * (1.0f - con),
        SSIM_MAP_CLIP);

    const float thr = depth_threshold(a.med);
    const float rf = a.ref[p], rd = a.depth[p];
    const float dm = (rf > 0.01f && rf < thr) ? 1.0f : 0.0f;
    const float l1d = fabsf(rd * dm - rf * dm);
    a.l1_depth[p] = l1d;
    const bool udm = rf < rd + 1.0f;
    v[0] = wl1;
    v[1] = weight;
    v[2] = udm ? weight * l1d : l1d;
    v[3] = ssim_sum;
  }
  block_sum<FWD_PART>(red, v, a.part + (long long)(blockIdx.y * gridDim.x +
                                                   blockIdx.x) * FWD_PART);
}

struct DownArgs {
  const float *slm, *opac, *l1_depth, *ref;
  float* small;  // (4, h, w): ssim_loss_map, opacity, depth L1, ref depth
  Axis bil_y, bil_x, bic_y, bic_x;
  int H, W, h, w;
};

__global__ void __launch_bounds__(DOWN_THREADS)
    loss_fwd_down(const DownArgs a) {
  __shared__ float row[MAX_W];
  const int i = blockIdx.x, map = blockIdx.y;
  const float* src = map == 0   ? a.slm
                     : map == 1 ? a.opac
                     : map == 2 ? a.l1_depth
                                : a.ref;
  const Axis ay = map < 2 ? a.bil_y : a.bic_y;
  const Axis ax = map < 2 ? a.bil_x : a.bic_x;
  const int sy = ay.start[i];
  const float* wy = ay.w + (long long)i * ay.taps;
  for (int x = threadIdx.x; x < a.W; x += DOWN_THREADS) {
    float s = 0.0f;
    for (int k = 0; k < ay.taps; ++k) {
      float v = src[(long long)(sy + k) * a.W + x];
      if (map == 2) v = clamp_max(v, DEPTH_MAX_CLIP);
      s += wy[k] * v;
    }
    row[x] = s;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < a.w; j += DOWN_THREADS) {
    const int sx = ax.start[j];
    const float* wx = ax.w + (long long)j * ax.taps;
    float s = 0.0f;
    for (int k = 0; k < ax.taps; ++k) s += wx[k] * row[sx + k];
    a.small[((long long)map * a.h + i) * a.w + j] = s;
  }
}

struct FinArgs {
  const float *small, *sigma, *med, *part;
  float *uncer, *du, *total, *sums;
  int n_part, H, W, h, w, k, use_ssim;
  float alpha, one_m_alpha, lambda, ssim_mult, depth_mult, opac_th;
};

__global__ void __launch_bounds__(FIN_THREADS)
    loss_fwd_finish(const FinArgs a) {
  __shared__ double red[FIN_THREADS];
  const int tid = threadIdx.x;
  const int n = a.h * a.w;
  const float thr = depth_threshold(a.med);
  const float* s_map = a.small;
  const float* s_opac = a.small + n;
  const float* s_dl = a.small + 2 * n;
  const float* s_dep = a.small + 3 * n;
  const int lo = (a.k - 1) / 2;
  double su = 0.0;
  for (int i = tid; i < n; i += FIN_THREADS) {
    const int yi = i / a.w, xi = i % a.w;
    // the k x k median of ssim_loss_map on the grid, zero padded
    float v[MAX_MEDIAN];
    int cnt = 0;
    bool has_nan = false;
    float nanv = 0.0f;
    for (int dy = 0; dy < a.k; ++dy)
      for (int dx = 0; dx < a.k; ++dx) {
        const int yy = yi - lo + dy, xx = xi - lo + dx;
        const float val = (yy >= 0 && yy < a.h && xx >= 0 && xx < a.w)
                              ? s_map[yy * a.w + xx]
                              : 0.0f;
        if (isnan(val)) {
          has_nan = true;
          nanv = val;
        }
        int j = cnt++;
        while (j > 0 && v[j - 1] > val) {
          v[j] = v[j - 1];
          --j;
        }
        v[j] = val;
      }
    const float F = has_nan ? nanv : (v[(cnt - 1) / 2] + v[cnt / 2]) * 0.5f;
    const float d = s_dep[i] > thr ? 0.0f : s_dl[i];
    const float s = a.sigma[i];
    const float pu = proc_unc(s);
    const float p2 = pu * pu;
    const float md = a.depth_mult * d;
    float u = (F / p2 + 0.5f * logf(pu)) + md / p2;
    // d u / d sigma: through proc_unc ** 2 twice and the log, then
    // the clamp (zero below 0.1)
    float g = (0.5f / pu - (F / (p2 * p2)) * (2.0f * pu))
              - (md / (p2 * p2)) * (2.0f * pu);
    g = s >= UNC_MIN ? g : 0.0f;
    if (s_opac[i] < a.opac_th) {
      u = 0.0f;
      g = 0.0f;
    }
    a.uncer[i] = u;
    a.du[i] = g;
    su += u;
  }
  double part[FWD_PART] = {0.0, 0.0, 0.0, 0.0};
  for (int b = tid; b < a.n_part; b += FIN_THREADS)
    for (int k = 0; k < FWD_PART; ++k)
      part[k] += a.part[(long long)b * FWD_PART + k];
  const double s_wl1 = fin_sum(part[0], red);
  const double s_w = fin_sum(part[1], red);
  const double s_d = fin_sum(part[2], red);
  const double s_ssim = fin_sum(part[3], red);
  const double s_u = fin_sum(su, red);
  if (tid == 0) {
    const double hw = (double)a.H * a.W, n3 = 3.0 * hw;
    // mean(w (1 - lambda) l1 + w lambda (1 - ssim)) over pixels and channels
    const double rgb =
        a.use_ssim ? (1.0 - (double)a.lambda) * s_wl1
                         + (double)a.lambda * (1.0 - s_ssim / n3) * 3.0 * s_w
                   : s_wl1;
    a.total[0] = (float)((double)a.alpha * (rgb / n3)
                         + (double)a.one_m_alpha * (s_d / hw)
                         + (double)a.ssim_mult * (s_u / n));
    a.sums[0] = (float)s_w;
  }
}

struct BwdArgs {
  const float *img, *depth, *gt, *ref, *exp_a, *exp_b, *med, *gauss;
  const float *weights, *coef, *sums, *g_total;
  float *g_img, *g_depth, *part;
  int H, W, init, use_ssim;
  float thr_rgb, alpha, one_m_alpha, lambda;
};

__global__ void __launch_bounds__(PIX_THREADS)
    loss_bwd_pixel(const BwdArgs a) {
  __shared__ float cs[3][HY][HX];  // one channel's coefficient maps, haloed
  __shared__ float vb[3][TY][HX];
  __shared__ float red[BWD_PART][PIX_THREADS];

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int px = x0 + tx, py = y0 + ty;
  const int H = a.H, W = a.W;
  const bool inside = px < W && py < H;
  const long long HW = (long long)H * W;
  const long long p = inside ? (long long)py * W + px : 0;
  const float expa = a.init ? 1.0f : expf(a.exp_a[0]);
  const float eb = a.init ? 0.0f : a.exp_b[0];
  const float g = a.g_total[0];
  const float n3 = (float)(3 * HW), nhw = (float)HW;
  // the gradient of each element of rgb_loss, and of l1_depth_w
  const float ge = (g * a.alpha) / n3;
  const float ged = (g * a.one_m_alpha) / nhw;
  // the gradient of each element of the window-11 ssim map
  const float ks = -(3.0f * a.lambda * ge * a.sums[0]) / n3;

  float w = 0.0f, m = 0.0f;
  if (inside) {
    w = a.weights[p];
    const float gsum = (a.gt[3 * p] + a.gt[3 * p + 1]) + a.gt[3 * p + 2];
    m = gsum > a.thr_rgb ? 1.0f : 0.0f;
  }
  const float gl1 = a.use_ssim ? (ge * w) * (1.0f - a.lambda) : ge * w;
  float pa = 0.0f, pb = 0.0f;
  for (int c = 0; c < 3; ++c) {
    float bl[3] = {0.0f, 0.0f, 0.0f};
    if (a.use_ssim) {
      __syncthreads();
      for (int i = tid; i < HY * HX; i += PIX_THREADS) {
        const int r = i / HX, q = i % HX;
        const int yy = y0 - R + r, xx = x0 - R + q;
        const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
        const long long o = (long long)yy * W + xx;
        for (int n = 0; n < 3; ++n)
          cs[n][r][q] = in ? a.coef[(3 * c + n) * HW + o] : 0.0f;
      }
      __syncthreads();
      for (int i = tid; i < TY * HX; i += PIX_THREADS) {
        const int r = i / HX, q = i % HX;
        float s[3] = {0.0f, 0.0f, 0.0f};
        for (int k = 0; k < WIN; ++k)
          for (int n = 0; n < 3; ++n) s[n] += a.gauss[k] * cs[n][r + k][q];
        for (int n = 0; n < 3; ++n) vb[n][r][q] = s[n];
      }
      __syncthreads();
      if (inside)
        for (int k = 0; k < WIN; ++k)
          for (int n = 0; n < 3; ++n) bl[n] += a.gauss[k] * vb[n][ty][tx + k];
    }
    if (!inside) continue;
    const long long o = 3 * p + c;
    const float v = a.img[o], yv = a.gt[o];
    const float xv = a.init ? v : expa * v + eb;
    float gab = gl1 * sgn(xv * m - yv * m) * m;
    if (a.use_ssim) gab += ks * ((bl[0] + 2.0f * xv * bl[1]) + yv * bl[2]);
    a.g_img[o] = a.init ? gab : gab * expa;
    pa += gab * v;
    pb += gab;
  }
  if (inside) {
    const float thr = depth_threshold(a.med);
    const float rf = a.ref[p], rd = a.depth[p];
    const float dm = (rf > 0.01f && rf < thr) ? 1.0f : 0.0f;
    const bool udm = rf < rd + 1.0f;
    const float gd = udm ? ged * w : ged;
    a.g_depth[p] = gd * sgn(rd * dm - rf * dm) * dm;
  }
  const float v[BWD_PART] = {pa, pb};
  block_sum<BWD_PART>(red, v, a.part + (long long)(blockIdx.y * gridDim.x +
                                                   blockIdx.x) * BWD_PART);
}

struct BwdFinArgs {
  const float *part, *du, *g_total, *g_uncer, *exp_a;
  float *g_exp, *g_sigma;
  int n_part, n;
  float ssim_mult;
};

__global__ void __launch_bounds__(FIN_THREADS)
    loss_bwd_finish(const BwdFinArgs a) {
  __shared__ double red[FIN_THREADS];
  const int tid = threadIdx.x;
  if (a.g_sigma != nullptr) {
    // uncer_loss's gradient: ssim_mult * mean's, and the output's own
    const float gu = (a.g_total[0] * a.ssim_mult) / (float)a.n;
    for (int i = tid; i < a.n; i += FIN_THREADS) {
      const float gi = a.g_uncer != nullptr ? gu + a.g_uncer[i] : gu;
      a.g_sigma[i] = gi * a.du[i];
    }
  }
  if (a.g_exp != nullptr) {
    double s[BWD_PART] = {0.0, 0.0};
    for (int b = tid; b < a.n_part; b += FIN_THREADS)
      for (int k = 0; k < BWD_PART; ++k)
        s[k] += a.part[(long long)b * BWD_PART + k];
    const double sa = fin_sum(s[0], red);
    const double sb = fin_sum(s[1], red);
    if (tid == 0) {
      a.g_exp[0] = (float)sa * expf(a.exp_a[0]);
      a.g_exp[1] = (float)sb;
    }
  }
}

dim3 pixel_grid(int H, int W) {
  return dim3((W + TX - 1) / TX, (H + TY - 1) / TY);
}

}  // namespace

// M1. img, gt (H, W, 3), depth, ref, opac (H, W), sigma (h, w), exp_a,
// exp_b, med (scalars; exp_* may be null at initialization), gauss (11 +
// ws taps); six axis tables (start, weights, taps): the upsample (h -> H,
// w -> W), bilinear and bicubic downsamples (H -> h, W -> w). Writes l1_rgb
// (H, W, 3), l1_depth, weights (H, W), uncer, du (h, w), total (1), sums
// (1); scratch slm (H, W), coef (9, H, W), part (blocks x 4), small (4, h,
// w).
extern "C" int mapping_loss_fwd(
    const float* img, const float* depth, const float* gt, const float* ref,
    const float* sigma, const float* opac, const float* exp_a,
    const float* exp_b, const float* med, const float* gauss,
    const int* up_y_start, const float* up_y_w, const int* up_x_start,
    const float* up_x_w, const int* bil_y_start, const float* bil_y_w,
    const int* bil_x_start, const float* bil_x_w, const int* bic_y_start,
    const float* bic_y_w, const int* bic_x_start, const float* bic_x_w,
    float* l1_rgb, float* l1_depth, float* weights, float* uncer, float* du,
    float* total, float* sums, float* slm, float* coef, float* part,
    float* small, int H, int W, int h, int w, int ws, int k, int init,
    int use_ssim, int up_y_taps, int up_x_taps, int bil_y_taps,
    int bil_x_taps, int bic_y_taps, int bic_x_taps, float thr_rgb,
    float data_rate, float ssim_weight, float alpha, float one_m_alpha,
    float lambda, float ssim_mult, float depth_mult, float opac_th,
    void* stream) {
  if (W > MAX_W || ws > WIN || ws % 2 == 0 || k * k > MAX_MEDIAN)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid = pixel_grid(H, W);
  FwdArgs fa;
  fa.img = img; fa.depth = depth; fa.gt = gt; fa.ref = ref; fa.sigma = sigma;
  fa.opac = opac; fa.exp_a = exp_a; fa.exp_b = exp_b; fa.med = med;
  fa.gauss = gauss; fa.l1_rgb = l1_rgb; fa.l1_depth = l1_depth;
  fa.weights = weights; fa.slm = slm; fa.coef = coef; fa.part = part;
  fa.up_y = Axis{up_y_start, up_y_w, up_y_taps};
  fa.up_x = Axis{up_x_start, up_x_w, up_x_taps};
  fa.H = H; fa.W = W; fa.h = h; fa.w = w; fa.ws = ws; fa.init = init;
  fa.use_ssim = use_ssim; fa.thr_rgb = thr_rgb; fa.data_rate = data_rate;
  fa.ssim_weight = ssim_weight;
  loss_fwd_pixel<<<grid, dim3(TX, TY), 0, st>>>(fa);

  DownArgs da;
  da.slm = slm; da.opac = opac; da.l1_depth = l1_depth; da.ref = ref;
  da.small = small;
  da.bil_y = Axis{bil_y_start, bil_y_w, bil_y_taps};
  da.bil_x = Axis{bil_x_start, bil_x_w, bil_x_taps};
  da.bic_y = Axis{bic_y_start, bic_y_w, bic_y_taps};
  da.bic_x = Axis{bic_x_start, bic_x_w, bic_x_taps};
  da.H = H; da.W = W; da.h = h; da.w = w;
  loss_fwd_down<<<dim3(h, 4), DOWN_THREADS, 0, st>>>(da);

  FinArgs fi;
  fi.small = small; fi.sigma = sigma; fi.med = med; fi.part = part;
  fi.uncer = uncer; fi.du = du; fi.total = total; fi.sums = sums;
  fi.n_part = (int)(grid.x * grid.y); fi.H = H; fi.W = W; fi.h = h;
  fi.w = w; fi.k = k; fi.use_ssim = use_ssim; fi.alpha = alpha;
  fi.one_m_alpha = one_m_alpha; fi.lambda = lambda; fi.ssim_mult = ssim_mult;
  fi.depth_mult = depth_mult; fi.opac_th = opac_th;
  loss_fwd_finish<<<1, FIN_THREADS, 0, st>>>(fi);
  return (int)cudaGetLastError();
}

// M2. The forward's inputs, its weights, coef and sums, the incoming
// gradients g_total (1) and g_uncer (h, w; may be null) -> g_img (H, W, 3),
// g_depth (H, W), g_exp (2; null: not asked, or at initialization) and
// g_sigma (h, w; null: not asked); scratch part (blocks x 2).
extern "C" int mapping_loss_bwd(
    const float* img, const float* depth, const float* gt, const float* ref,
    const float* exp_a, const float* exp_b, const float* med,
    const float* gauss, const float* weights, const float* coef,
    const float* sums, const float* du, const float* g_total,
    const float* g_uncer, float* g_img, float* g_depth, float* g_exp,
    float* g_sigma, float* part, int H, int W, int h, int w, int init,
    int use_ssim, float thr_rgb, float alpha, float one_m_alpha, float lambda,
    float ssim_mult, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid = pixel_grid(H, W);
  BwdArgs ba;
  ba.img = img; ba.depth = depth; ba.gt = gt; ba.ref = ref; ba.exp_a = exp_a;
  ba.exp_b = exp_b; ba.med = med; ba.gauss = gauss; ba.weights = weights;
  ba.coef = coef; ba.sums = sums; ba.g_total = g_total; ba.g_img = g_img;
  ba.g_depth = g_depth; ba.part = part; ba.H = H; ba.W = W; ba.init = init;
  ba.use_ssim = use_ssim; ba.thr_rgb = thr_rgb; ba.alpha = alpha;
  ba.one_m_alpha = one_m_alpha; ba.lambda = lambda;
  loss_bwd_pixel<<<grid, dim3(TX, TY), 0, st>>>(ba);

  BwdFinArgs bf;
  bf.part = part; bf.du = du; bf.g_total = g_total; bf.g_uncer = g_uncer;
  bf.exp_a = exp_a; bf.g_exp = g_exp; bf.g_sigma = g_sigma;
  bf.n_part = (int)(grid.x * grid.y); bf.n = h * w; bf.ssim_mult = ssim_mult;
  loss_bwd_finish<<<1, FIN_THREADS, 0, st>>>(bf);
  return (int)cudaGetLastError();
}
