// JPEG decoding with libjpeg's default output, so that the result equals
// cv2.imread(path) (which decodes through libjpeg-turbo) bit for bit:
//   - baseline and extended sequential (SOF0/SOF1) and progressive (SOF2)
//     Huffman coding, 8-bit samples, 1 or 3 components, any integer
//     sampling factors, restart intervals; APPn and COM segments skipped
//     (APP1 Exif read for its orientation, APP0/APP14 for the colour
//     transform);
//   - the integer "ISLOW" inverse DCT of jidctint.c (13-bit constants,
//     two passes, the post-IDCT range-limit table);
//   - jdsample.c's "fancy" triangle upsampling for h2v1, h1v2 and h2v2
//     chroma (with its alternating rounding biases and replicated edges),
//     replication for every other integer factor;
//   - jdcolor.c's fixed-point YCbCr -> RGB tables.
// Arithmetic coding, lossless, hierarchical, 12-bit and 2- or
// 4-component files raise. Corrupt data raises where libjpeg would only
// warn: a bad Huffman code, a coefficient index past 63, a missing or
// misnumbered restart marker, entropy-coded data that ends early, no EOI.

#include <algorithm>
#include <cstring>

#include "native.h"

namespace wn {
namespace {

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

struct Huffman {
  bool defined = false;
  uint8_t look_len[512], look_sym[512];   // 9-bit lookahead
  int maxcode[18], mincode[17], valptr[17];
  uint8_t vals[256];
};

void build_huffman(Huffman* h, const uint8_t* counts, const uint8_t* vals,
                   int n_vals) {
  std::memset(h->look_len, 0, sizeof(h->look_len));
  std::memcpy(h->vals, vals, n_vals);
  int code = 0, p = 0;
  for (int l = 1; l <= 16; l++) {
    if (counts[l - 1]) {
      h->valptr[l] = p;
      h->mincode[l] = code;
      for (int i = 0; i < counts[l - 1]; i++, p++, code++) {
        if (l <= 9) {
          int base = code << (9 - l);
          for (int j = 0; j < (1 << (9 - l)); j++) {
            h->look_len[base + j] = uint8_t(l);
            h->look_sym[base + j] = vals[p];
          }
        }
      }
      h->maxcode[l] = code - 1;
      if (code - 1 >= (1 << l)) throw DecodeError("bad Huffman table");
    } else {
      h->maxcode[l] = -1;
    }
    code <<= 1;
  }
  h->maxcode[17] = 0x7FFFFFFF;
  h->defined = true;
}

// MSB-first reader of entropy-coded data: undoes 0xFF00 stuffing, stops
// at a marker (or the end of the file) and supplies zero bits after it;
// consuming one of those is corrupt or truncated data.
struct Bits {
  const uint8_t* p;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0, fill = 0;
  bool at_marker = false;

  void refill() {
    while (cnt <= 56) {
      unsigned b = 0;
      if (!at_marker && pos < n) {
        b = p[pos];
        if (b == 0xFF) {
          if (pos + 1 < n && p[pos + 1] == 0) {
            pos += 2;
          } else {
            at_marker = true;
            b = 0;
            fill += 8;
          }
        } else {
          pos++;
        }
      } else {
        fill += 8;
      }
      buf = (buf << 8) | b;
      cnt += 8;
    }
  }
  unsigned peek(int s) const {
    return unsigned(buf >> (cnt - s)) & ((1u << s) - 1);
  }
  void consume(int s) {
    cnt -= s;
    if (cnt < fill)
      throw DecodeError("corrupt or truncated entropy-coded data");
  }
  int get(int s) {
    if (s == 0) return 0;
    if (cnt < s) refill();
    int v = int(peek(s));
    consume(s);
    return v;
  }
  int bit() { return get(1); }
  int decode(const Huffman& h) {
    if (cnt < 16) refill();
    unsigned look = peek(9);
    if (int l = h.look_len[look]) {
      consume(l);
      return h.look_sym[look];
    }
    for (int l = 10; l <= 16; l++) {
      int code = int(peek(l));
      if (code <= h.maxcode[l]) {
        consume(l);
        return h.vals[h.valptr[l] + code - h.mincode[l]];
      }
    }
    throw DecodeError("bad Huffman code");
  }
  // The restart marker RSTn that must come next; at most the padding of
  // the last byte may be left before it.
  void restart(int n_expected) {
    if (cnt - fill >= 8) throw DecodeError("data before a restart marker");
    if (!at_marker && (pos >= n || p[pos] != 0xFF))
      throw DecodeError("missing restart marker");
    while (pos < n && p[pos] == 0xFF) pos++;
    if (pos >= n || p[pos] != 0xD0 + n_expected)
      throw DecodeError("missing restart marker");
    pos++;
    buf = 0;
    cnt = fill = 0;
    at_marker = false;
  }
};

int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id, h, v, tq;
  int dw, dh;        // samples of the component (downsampled size)
  int bw, bh;        // blocks in its coefficient array (whole MCUs)
  int pred = 0;
  bool seen = false;
  uint16_t q[64];    // natural order, latched at its first scan
  std::vector<int16_t> coef;
};

struct Decoder {
  const uint8_t* p = nullptr;
  size_t n = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool frame = false, progressive = false, jfif = false, adobe = false;
  int adobe_transform = -1, orientation = 1;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  int eobrun = 0;

  void sof(const uint8_t* s, int len, int marker, bool header_only);
  void dht(const uint8_t* s, int len);
  void dqt(const uint8_t* s, int len);
  size_t sos(const uint8_t* s, int len, size_t pos);
  void output(Image* out);
};

void Decoder::dqt(const uint8_t* s, int len) {
  while (len > 0) {
    int pq = s[0] >> 4, tq = s[0] & 15, need = 1 + 64 * (pq ? 2 : 1);
    if (pq > 1 || tq > 3 || len < need) throw DecodeError("bad DQT segment");
    for (int k = 0; k < 64; k++)
      qt[tq][kZigzag[k]] =
          uint16_t(pq ? be16(s + 1 + 2 * k) : s[1 + k]);
    qt_defined[tq] = true;
    s += need;
    len -= need;
  }
}

void Decoder::dht(const uint8_t* s, int len) {
  while (len > 0) {
    if (len < 17) throw DecodeError("bad DHT segment");
    int tc = s[0] >> 4, th = s[0] & 15, total = 0;
    for (int i = 0; i < 16; i++) total += s[1 + i];
    if (tc > 1 || th > 3 || total > 256 || len < 17 + total)
      throw DecodeError("bad DHT segment");
    build_huffman(tc ? &ac[th] : &dc[th], s + 1, s + 17, total);
    s += 17 + total;
    len -= 17 + total;
  }
}

void Decoder::sof(const uint8_t* s, int len, int marker, bool header_only) {
  if (frame) throw DecodeError("more than one frame header");
  if (len < 6) throw DecodeError("bad SOF segment");
  if (s[0] != 8)
    throw DecodeError(std::to_string(s[0]) +
                      "-bit samples are not supported (8-bit only)");
  height = be16(s + 1);
  width = be16(s + 3);
  int nc = s[5];
  if (!height) throw DecodeError("height 0 (a DNL marker) is not supported");
  if (!width) throw DecodeError("width 0");
  if (nc != 1 && nc != 3)
    throw DecodeError(std::to_string(nc) +
                      " components are not supported (1 or 3)");
  if (len < 6 + 3 * nc) throw DecodeError("bad SOF segment");
  frame = true;
  progressive = marker == 0xC2;
  comps.resize(nc);
  for (int i = 0; i < nc; i++) {
    Component& c = comps[i];
    c.id = s[6 + 3 * i];
    c.h = s[7 + 3 * i] >> 4;
    c.v = s[7 + 3 * i] & 15;
    c.tq = s[8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      throw DecodeError("bad sampling factors or table in SOF");
    hmax = std::max(hmax, c.h);
    vmax = std::max(vmax, c.v);
  }
  mcux = (width + 8 * hmax - 1) / (8 * hmax);
  mcuy = (height + 8 * vmax - 1) / (8 * vmax);
  uint64_t total = 0;
  for (Component& c : comps) {
    if (nc > 1 && (hmax % c.h || vmax % c.v))
      throw DecodeError("fractional sampling factors are not supported");
    c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
    c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
    c.bw = mcux * c.h;
    c.bh = mcuy * c.v;
    total += uint64_t(c.bw) * c.bh * 64 * 2;
  }
  if (total > kMaxImageBytes) throw DecodeError("image too large");
  if (!header_only)
    for (Component& c : comps) c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
}

// One scan: its header at `s`, its entropy-coded data at `pos`; returns the
// position after that data.
size_t Decoder::sos(const uint8_t* s, int len, size_t pos) {
  if (!frame) throw DecodeError("scan before the frame header");
  int ns = len > 0 ? s[0] : 0;
  if (ns < 1 || ns > int(comps.size()) || len < 4 + 2 * ns)
    throw DecodeError("bad SOS segment");
  Component* sc[4];
  int tdc[4], tac[4];
  for (int i = 0; i < ns; i++) {
    int id = s[1 + 2 * i];
    sc[i] = nullptr;
    for (Component& c : comps)
      if (c.id == id) sc[i] = &c;
    if (!sc[i]) throw DecodeError("scan names an unknown component");
    for (int j = 0; j < i; j++)
      if (sc[j] == sc[i]) throw DecodeError("scan names a component twice");
    tdc[i] = s[2 + 2 * i] >> 4;
    tac[i] = s[2 + 2 * i] & 15;
    if (tdc[i] > 3 || tac[i] > 3) throw DecodeError("bad SOS segment");
  }
  int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
  int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
  // 0 sequential, 1 DC first, 2 DC refine, 3 AC first, 4 AC refine
  int mode = 0;
  if (progressive) {
    bool ok = ss == 0 ? se == 0 : (se >= ss && se <= 63 && ns == 1);
    ok &= al <= 13 && (ah == 0 || al == ah - 1);
    if (!ok) throw DecodeError("bad progressive scan parameters");
    mode = ss == 0 ? (ah ? 2 : 1) : (ah ? 4 : 3);
  } else {
    ss = 0;
    se = 63;
    ah = al = 0;
  }
  int blocks_per_mcu = 0;
  for (int i = 0; i < ns; i++) {
    Component& c = *sc[i];
    if (!c.seen) {
      if (!qt_defined[c.tq]) throw DecodeError("undefined quantization table");
      std::memcpy(c.q, qt[c.tq], sizeof(c.q));
      c.seen = true;
    }
    if ((mode <= 1 && !dc[tdc[i]].defined) ||
        ((mode == 0 || mode >= 3) && !ac[tac[i]].defined))
      throw DecodeError("undefined Huffman table");
    blocks_per_mcu += c.h * c.v;
    c.pred = 0;
  }
  if (ns > 1 && blocks_per_mcu > 10)
    throw DecodeError("too many blocks per MCU");
  eobrun = 0;
  Bits b{p, n, pos};

  auto block = [&](int i, int16_t* blk) {
    Component& c = *sc[i];
    switch (mode) {
      case 0:
      case 1: {
        int t = b.decode(dc[tdc[i]]);
        if (t > 11) throw DecodeError("bad DC coefficient");
        c.pred += t ? extend(b.get(t), t) : 0;
        blk[0] = int16_t(mode ? c.pred * (1 << al) : c.pred);
        if (mode) return;
        const Huffman& h = ac[tac[i]];
        for (int k = 1; k < 64; k++) {
          int rs = b.decode(h), r = rs >> 4, sz = rs & 15;
          if (sz) {
            k += r;
            if (k > 63) throw DecodeError("coefficient index past 63");
            blk[kZigzag[k]] = int16_t(extend(b.get(sz), sz));
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
        return;
      }
      case 2:
        if (b.bit()) blk[0] = int16_t(blk[0] | (1 << al));
        return;
      case 3: {
        if (eobrun) {
          eobrun--;
          return;
        }
        const Huffman& h = ac[tac[i]];
        for (int k = ss; k <= se; k++) {
          int rs = b.decode(h), r = rs >> 4, sz = rs & 15;
          if (sz) {
            k += r;
            if (k > 63) throw DecodeError("coefficient index past 63");
            blk[kZigzag[k]] = int16_t(extend(b.get(sz), sz) * (1 << al));
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = (1 << r) - 1;
            if (r) eobrun += b.get(r);
            break;
          }
        }
        return;
      }
      default: {   // AC refinement (jdphuff.c decode_mcu_AC_refine)
        const int p1 = 1 << al, m1 = -p1;
        const Huffman& h = ac[tac[i]];
        int k = ss;
        auto refine = [&](int16_t* coef) {
          if (b.bit() && (*coef & p1) == 0)
            *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
        };
        if (!eobrun) {
          for (; k <= se; k++) {
            int rs = b.decode(h), r = rs >> 4, sz = rs & 15, val = 0;
            if (sz) {
              if (sz != 1) throw DecodeError("bad refinement code");
              val = b.bit() ? p1 : m1;
            } else if (r != 15) {
              eobrun = 1 << r;
              if (r) eobrun += b.get(r);
              break;
            }
            for (; k <= se; k++) {
              int16_t* coef = blk + kZigzag[k];
              if (*coef) {
                refine(coef);
              } else if (--r < 0) {
                break;
              }
            }
            if (val) {
              if (k > se) throw DecodeError("coefficient index past the band");
              blk[kZigzag[k]] = int16_t(val);
            }
          }
        }
        if (eobrun) {
          for (; k <= se; k++)
            if (blk[kZigzag[k]]) refine(blk + kZigzag[k]);
          eobrun--;
        }
      }
    }
  };

  const bool single = ns == 1;
  const int nx = single ? (sc[0]->dw + 7) / 8 : mcux;
  const int ny = single ? (sc[0]->dh + 7) / 8 : mcuy;
  int todo = restart_interval, rst = 0;
  for (int my = 0; my < ny; my++) {
    for (int mx = 0; mx < nx; mx++) {
      if (restart_interval) {
        if (todo == 0) {
          b.restart(rst);
          rst = (rst + 1) & 7;
          todo = restart_interval;
          eobrun = 0;
          for (int i = 0; i < ns; i++) sc[i]->pred = 0;
        }
        todo--;
      }
      if (single) {
        Component& c = *sc[0];
        block(0, c.coef.data() + (size_t(my) * c.bw + mx) * 64);
        continue;
      }
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i];
        for (int v = 0; v < c.v; v++)
          for (int h = 0; h < c.h; h++)
            block(i, c.coef.data() +
                         (size_t(my * c.v + v) * c.bw + mx * c.h + h) * 64);
      }
    }
  }
  return b.pos;
}

// ------------------------------------------------------------------ output

// libjpeg's post-IDCT range limit: the sample (centred on 0) masked to
// 10 bits, then clamped, as jdmaster.c's prepare_range_limit_table lays it.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++)
      t[i] = uint8_t(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
  }
};
const RangeLimit kRange;

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// jidctint.c's jpeg_idct_islow: one block into 8 rows of `out`.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* x = in + c;
    const uint16_t* qq = q + c;
    int* w = ws + c;
    if (!x[8] && !x[16] && !x[24] && !x[32] && !x[40] && !x[48] && !x[56]) {
      int dc = int(x[0]) * qq[0] * (1 << kPass1Bits);
      for (int k = 0; k < 8; k++) w[8 * k] = dc;
      continue;
    }
    int64_t z2 = int64_t(x[16]) * qq[16], z3 = int64_t(x[48]) * qq[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(x[0]) * qq[0];
    z3 = int64_t(x[32]) * qq[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(x[56]) * qq[56];
    tmp1 = int64_t(x[40]) * qq[40];
    tmp2 = int64_t(x[24]) * qq[24];
    tmp3 = int64_t(x[8]) * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    w[0] = int(descale(tmp10 + tmp3, sh));
    w[56] = int(descale(tmp10 - tmp3, sh));
    w[8] = int(descale(tmp11 + tmp2, sh));
    w[48] = int(descale(tmp11 - tmp2, sh));
    w[16] = int(descale(tmp12 + tmp1, sh));
    w[40] = int(descale(tmp12 - tmp1, sh));
    w[24] = int(descale(tmp13 + tmp0, sh));
    w[32] = int(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = kRange.t[int(descale(w[0], kPass1Bits + 3)) & 1023];
      std::memset(o, v, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[int(descale(tmp10 + tmp3, sh)) & 1023];
    o[7] = kRange.t[int(descale(tmp10 - tmp3, sh)) & 1023];
    o[1] = kRange.t[int(descale(tmp11 + tmp2, sh)) & 1023];
    o[6] = kRange.t[int(descale(tmp11 - tmp2, sh)) & 1023];
    o[2] = kRange.t[int(descale(tmp12 + tmp1, sh)) & 1023];
    o[5] = kRange.t[int(descale(tmp12 - tmp1, sh)) & 1023];
    o[3] = kRange.t[int(descale(tmp13 + tmp0, sh)) & 1023];
    o[4] = kRange.t[int(descale(tmp13 - tmp0, sh)) & 1023];
  }
}

// A component's samples (stride `sw`) upsampled to the full image, as
// jdsample.c: fancy h2v1 / h2v2 where the component is more than 2 wide,
// fancy h1v2, replication otherwise.
void upsample(const uint8_t* s, size_t sw, int dw, int dh, int fh, int fv,
              int width, int height, uint8_t* out) {
  std::vector<uint8_t> row(size_t(dw) * fh + 2);
  for (int y = 0; y < height; y++) {
    uint8_t* o = out + size_t(y) * width;
    const uint8_t* in0 = s + size_t(y / fv) * sw;
    if (fh == 2 && fv == 2 && dw > 2) {
      int i = y / 2, nb = std::clamp(y % 2 ? i + 1 : i - 1, 0, dh - 1);
      const uint8_t* in1 = s + size_t(nb) * sw;
      auto col = [&](int j) { return in0[j] * 3 + in1[j]; };
      int last = col(0), cur = col(0), next = col(1);
      row[0] = uint8_t((cur * 4 + 8) >> 4);
      row[1] = uint8_t((cur * 3 + next + 7) >> 4);
      for (int j = 1; j < dw - 1; j++) {
        last = cur;
        cur = next;
        next = col(j + 1);
        row[2 * j] = uint8_t((cur * 3 + last + 8) >> 4);
        row[2 * j + 1] = uint8_t((cur * 3 + next + 7) >> 4);
      }
      last = cur;
      cur = next;
      row[2 * dw - 2] = uint8_t((cur * 3 + last + 8) >> 4);
      row[2 * dw - 1] = uint8_t((cur * 4 + 7) >> 4);
      std::memcpy(o, row.data(), width);
    } else if (fh == 2 && fv == 1 && dw > 2) {
      row[0] = in0[0];
      row[1] = uint8_t((in0[0] * 3 + in0[1] + 2) >> 2);
      for (int j = 1; j < dw - 1; j++) {
        int v = in0[j] * 3;
        row[2 * j] = uint8_t((v + in0[j - 1] + 1) >> 2);
        row[2 * j + 1] = uint8_t((v + in0[j + 1] + 2) >> 2);
      }
      row[2 * dw - 2] = uint8_t((in0[dw - 1] * 3 + in0[dw - 2] + 1) >> 2);
      row[2 * dw - 1] = in0[dw - 1];
      std::memcpy(o, row.data(), width);
    } else if (fh == 1 && fv == 2) {
      int i = y / 2, bias = y % 2 ? 2 : 1;
      int nb = std::clamp(y % 2 ? i + 1 : i - 1, 0, dh - 1);
      const uint8_t* in1 = s + size_t(nb) * sw;
      for (int x = 0; x < width; x++)
        o[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
    } else if (fh == 1) {
      std::memcpy(o, in0, width);
    } else {
      for (int x = 0; x < width; x++) o[x] = in0[x / fh];
    }
  }
}

void Decoder::output(Image* out) {
  const int nc = int(comps.size());
  std::vector<std::vector<uint8_t>> full(nc);
  for (int ci = 0; ci < nc; ci++) {
    Component& c = comps[ci];
    size_t sw = size_t(c.bw) * 8;
    std::vector<uint8_t> plane(sw * size_t(c.bh) * 8);
    static const uint16_t zero_q[64] = {0};
    const uint16_t* q = c.seen ? c.q : zero_q;
    int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
    for (int by = 0; by < nby; by++)
      for (int bx = 0; bx < nbx; bx++)
        idct_islow(c.coef.data() + (size_t(by) * c.bw + bx) * 64, q,
                   plane.data() + size_t(by) * 8 * sw + bx * 8, sw);
    full[ci].resize(size_t(width) * height);
    int fh = nc == 1 ? 1 : hmax / c.h, fv = nc == 1 ? 1 : vmax / c.v;
    upsample(plane.data(), sw, c.dw, c.dh, fh, fv, width, height,
             full[ci].data());
  }
  out->data.resize(size_t(width) * height * nc);
  uint8_t* o = out->data.data();
  const size_t npx = size_t(width) * height;
  if (nc == 1) {
    std::memcpy(o, full[0].data(), npx);
    return;
  }
  bool rgb;
  if (jfif) rgb = false;
  else if (adobe) rgb = adobe_transform == 0;
  else rgb = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  const uint8_t *y = full[0].data(), *cb = full[1].data(), *cr = full[2].data();
  if (rgb) {
    for (size_t i = 0; i < npx; i++) {
      o[3 * i] = y[i];
      o[3 * i + 1] = cb[i];
      o[3 * i + 2] = cr[i];
    }
    return;
  }
  // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
  static const struct Tables {
    int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    Tables() {
      auto fix = [](double x) { return int(x * 65536 + 0.5); };
      for (int i = 0; i < 256; i++) {
        int x = i - 128;
        cr_r[i] = (fix(1.40200) * x + 32768) >> 16;
        cb_b[i] = (fix(1.77200) * x + 32768) >> 16;
        cr_g[i] = -fix(0.71414) * x;
        cb_g[i] = -fix(0.34414) * x + 32768;
      }
    }
  } t;
  auto clamp8 = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (size_t i = 0; i < npx; i++) {
    int Y = y[i], b = cb[i], r = cr[i];
    o[3 * i] = clamp8(Y + t.cr_r[r]);
    o[3 * i + 1] = clamp8(Y + ((t.cb_g[b] + t.cr_g[r]) >> 16));
    o[3 * i + 2] = clamp8(Y + t.cb_b[b]);
  }
}

}  // namespace

void decode_jpeg(const uint8_t* p, size_t n, bool header_only, Image* out) {
  if (n < 2 || p[0] != 0xFF || p[1] != 0xD8)
    throw DecodeError("not a JPEG file");
  Decoder d;
  d.p = p;
  d.n = n;
  size_t pos = 2;
  bool scanned = false;
  for (;;) {
    while (pos < n && p[pos] != 0xFF) pos++;   // bytes before a marker
    while (pos < n && p[pos] == 0xFF) pos++;   // fill bytes
    if (pos >= n) throw DecodeError("truncated (no EOI marker)");
    int m = p[pos++];
    if (m == 0) continue;   // a stuffed 0xFF at the end of a scan
    if (m == 0xD9) break;
    if (m == 0xD8) throw DecodeError("a second SOI marker");
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (pos + 2 > n) throw DecodeError("truncated marker segment");
    int len = be16(p + pos);
    if (len < 2 || pos + len > n) throw DecodeError("truncated marker segment");
    const uint8_t* s = p + pos + 2;
    int sl = len - 2;
    pos += len;
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
        d.sof(s, sl, m, header_only);
        break;
      case 0xC3:
        throw DecodeError("lossless JPEG is not supported");
      case 0xC5: case 0xC6: case 0xC7: case 0xDE: case 0xDF:
        throw DecodeError("hierarchical JPEG is not supported");
      case 0xC9: case 0xCA: case 0xCB: case 0xCC:
      case 0xCD: case 0xCE: case 0xCF:
        throw DecodeError("arithmetic-coded JPEG is not supported");
      case 0xC4:
        d.dht(s, sl);
        break;
      case 0xDB:
        d.dqt(s, sl);
        break;
      case 0xDD:
        if (sl < 2) throw DecodeError("bad DRI segment");
        d.restart_interval = be16(s);
        break;
      case 0xDA:
        if (header_only) {
          if (!d.frame) throw DecodeError("scan before the frame header");
          out->height = d.height;
          out->width = d.width;
          out->channels = int(d.comps.size());
          out->bytes = 1;
          out->orientation = d.orientation;
          return;
        }
        pos = d.sos(s, sl, pos);
        scanned = true;
        break;
      case 0xE0:
        if (sl >= 5 && !std::memcmp(s, "JFIF", 5)) d.jfif = true;
        break;
      case 0xE1:
        if (sl >= 6 && !std::memcmp(s, "Exif\0\0", 6))
          d.orientation = exif_orientation(s + 6, size_t(sl - 6));
        break;
      case 0xEE:
        if (sl >= 12 && !std::memcmp(s, "Adobe", 5)) {
          d.adobe = true;
          d.adobe_transform = s[11];
        }
        break;
      default:
        break;   // other APPn, COM, DNL past the frame, JPGn
    }
  }
  if (!d.frame || !scanned) throw DecodeError("no frame or no scan before EOI");
  if (header_only) throw DecodeError("no scan");
  out->height = d.height;
  out->width = d.width;
  out->channels = int(d.comps.size());
  out->bytes = 1;
  out->orientation = d.orientation;
  d.output(out);
}

}  // namespace wn
