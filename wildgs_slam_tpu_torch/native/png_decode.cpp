// PNG decoding: the chunk layout with every CRC checked, zlib inflate with
// its Adler-32, the five row filters undone row by row, Adam7 interlace,
// and the samples laid out as cv2.imread(path, IMREAD_UNCHANGED) returns
// them (in RGB order):
//   colour type 0 (grey): one channel, 1/2/4-bit samples scaled to 8 bits,
//     tRNS ignored;
//   2 (RGB): three channels, four with tRNS (alpha 0 on the transparent
//     colour, full elsewhere);
//   3 (palette): RGB from PLTE, RGBA with tRNS (255 past its entries);
//   4 (grey + alpha): G, G, G, A;
//   6 (RGBA): four channels.
// 16-bit files give 16-bit samples (host order), everything else 8-bit.

#include <algorithm>
#include <cstring>
#include <utility>

#include "native.h"

namespace wn {
namespace {

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | p[3];
}

struct Crc32 {
  uint32_t table[256];
  Crc32() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
  }
  uint32_t operator()(const uint8_t* p, size_t n, uint32_t crc = 0) const {
    crc = ~crc;
    for (size_t i = 0; i < n; i++) crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
    return ~crc;
  }
};
const Crc32 crc32;

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    size_t k = n < 5552 ? n : 5552;   // the most that cannot overflow
    n -= k;
    while (k--) {
      a += *p++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

// ------------------------------------------------------------------ inflate

constexpr int kFastBits = 9;

struct Huffman {
  uint16_t fast[1 << kFastBits];   // (length << 9) | symbol, 0 if longer
  uint16_t firstcode[17];
  int maxcode[18];
  uint16_t firstsymbol[17];
  uint8_t size[288];
  uint16_t value[288];
};

int bit_reverse(int v, int bits) {
  int r = 0;
  for (int i = 0; i < bits; i++) {
    r = (r << 1) | (v & 1);
    v >>= 1;
  }
  return r;
}

// Canonical code from code lengths (RFC 1951 3.2.2); an over-subscribed
// set is refused, an incomplete one allowed (a lone distance code).
void build_huffman(Huffman* h, const uint8_t* lengths, int num) {
  int sizes[17] = {0}, next_code[16];
  std::memset(h->fast, 0, sizeof(h->fast));
  for (int i = 0; i < num; i++) sizes[lengths[i]]++;
  sizes[0] = 0;
  int code = 0, k = 0;
  for (int i = 1; i < 16; i++) {
    next_code[i] = code;
    h->firstcode[i] = uint16_t(code);
    h->firstsymbol[i] = uint16_t(k);
    code += sizes[i];
    if (sizes[i] && code - 1 >= (1 << i))
      throw DecodeError("corrupt deflate stream (over-subscribed code)");
    h->maxcode[i] = code << (16 - i);
    code <<= 1;
    k += sizes[i];
  }
  h->maxcode[16] = 0x10000;
  for (int i = 0; i < num; i++) {
    int s = lengths[i];
    if (!s) continue;
    int c = next_code[s] - h->firstcode[s] + h->firstsymbol[s];
    h->size[c] = uint8_t(s);
    h->value[c] = uint16_t(i);
    if (s <= kFastBits) {
      for (int j = bit_reverse(next_code[s], s); j < (1 << kFastBits);
           j += 1 << s)
        h->fast[j] = uint16_t((s << 9) | i);
    }
    next_code[s]++;
  }
}

// LSB-first bit reader; past the end it supplies zero bytes and counts
// them, and consuming one of their bits is a truncated stream.
struct BitIn {
  const uint8_t* p;
  size_t n, pos = 0;
  uint64_t buf = 0;
  int cnt = 0, pad = 0;

  void refill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (pos < n) b = p[pos++];
      else pad++;
      buf |= b << cnt;
      cnt += 8;
    }
  }
  void consume(int s) {
    buf >>= s;
    cnt -= s;
    if (cnt < 8 * pad) throw DecodeError("truncated deflate stream");
  }
  int get(int s) {
    if (s == 0) return 0;
    if (cnt < s) refill();
    int v = int(buf & ((uint64_t(1) << s) - 1));
    consume(s);
    return v;
  }
  int decode(const Huffman& h) {
    if (cnt < 16) refill();
    int f = h.fast[buf & ((1 << kFastBits) - 1)];
    if (f) {
      consume(f >> 9);
      return f & 511;
    }
    int k = bit_reverse(int(buf & 0xFFFF), 16), s;
    for (s = kFastBits + 1; k >= h.maxcode[s]; s++) {}
    if (s >= 16) throw DecodeError("corrupt deflate stream (bad code)");
    int b = (k >> (16 - s)) - h.firstcode[s] + h.firstsymbol[s];
    if (b >= 288 || h.size[b] != s)
      throw DecodeError("corrupt deflate stream (bad code)");
    consume(s);
    return h.value[b];
  }
};

const int kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                          15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                          67, 83, 99, 115, 131, 163, 195, 227, 258};
const int kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                           2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const int kDistBase[30] = {1,    2,    3,    4,     5,     7,    9,    13,
                           17,   25,   33,   49,    65,    97,   129,  193,
                           257,  385,  513,  769,   1025,  1537, 2049, 3073,
                           4097, 6145, 8193, 12289, 16385, 24577};
const int kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                            6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// zlib stream (RFC 1950) -> exactly `expected` bytes.
std::vector<uint8_t> zlib_inflate(const uint8_t* p, size_t n,
                                  size_t expected) {
  if (n < 2 || (p[0] & 15) != 8 || (p[0] >> 4) > 7 ||
      ((p[0] << 8) | p[1]) % 31 || (p[1] & 32))
    throw DecodeError("bad zlib header in the image data");
  std::vector<uint8_t> out(expected);
  size_t o = 0;
  BitIn in{p + 2, n - 2};
  static const Huffman* fixed = [] {
    static Huffman lit, dist;
    uint8_t len[288];
    for (int i = 0; i < 288; i++)
      len[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
    build_huffman(&lit, len, 288);
    std::memset(len, 5, 30);
    build_huffman(&dist, len, 30);
    static Huffman both[2] = {lit, dist};
    return both;
  }();
  Huffman dyn[2];
  bool final = false;
  while (!final) {
    final = in.get(1);
    int type = in.get(2);
    if (type == 0) {
      in.get(in.cnt & 7);   // to a byte boundary
      int len = in.get(16), nlen = in.get(16);
      if ((len ^ 0xFFFF) != nlen)
        throw DecodeError("corrupt deflate stream (stored block length)");
      if (o + len > expected) throw DecodeError("too much image data");
      while (len && in.cnt >= 8) {
        out[o++] = uint8_t(in.get(8));
        len--;
      }
      if (in.pos + len > in.n) throw DecodeError("truncated deflate stream");
      std::memcpy(out.data() + o, in.p + in.pos, len);
      o += len;
      in.pos += len;
      continue;
    }
    const Huffman *lit, *dist;
    if (type == 1) {
      lit = &fixed[0];
      dist = &fixed[1];
    } else if (type == 2) {
      static const uint8_t order[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                        11, 4,  12, 3, 13, 2, 14, 1, 15};
      int hlit = in.get(5) + 257, hdist = in.get(5) + 1, hclen = in.get(4) + 4;
      uint8_t cl[19] = {0}, lens[288 + 32];
      for (int i = 0; i < hclen; i++) cl[order[i]] = uint8_t(in.get(3));
      Huffman clh;
      build_huffman(&clh, cl, 19);
      int k = 0;
      while (k < hlit + hdist) {
        int c = in.decode(clh), rep = 0;
        uint8_t fill = 0;
        if (c < 16) {
          lens[k++] = uint8_t(c);
          continue;
        } else if (c == 16) {
          if (!k) throw DecodeError("corrupt deflate stream (repeat)");
          rep = 3 + in.get(2);
          fill = lens[k - 1];
        } else if (c == 17) {
          rep = 3 + in.get(3);
        } else {
          rep = 11 + in.get(7);
        }
        if (k + rep > hlit + hdist)
          throw DecodeError("corrupt deflate stream (code lengths)");
        std::memset(lens + k, fill, rep);
        k += rep;
      }
      if (!lens[256]) throw DecodeError("corrupt deflate stream (no end code)");
      build_huffman(&dyn[0], lens, hlit);
      build_huffman(&dyn[1], lens + hlit, hdist);
      lit = &dyn[0];
      dist = &dyn[1];
    } else {
      throw DecodeError("corrupt deflate stream (block type 3)");
    }
    for (;;) {
      int sym = in.decode(*lit);
      if (sym < 256) {
        if (o >= expected) throw DecodeError("too much image data");
        out[o++] = uint8_t(sym);
        continue;
      }
      if (sym == 256) break;
      sym -= 257;
      if (sym >= 29) throw DecodeError("corrupt deflate stream (length)");
      int len = kLenBase[sym] + in.get(kLenExtra[sym]);
      int d = in.decode(*dist);
      if (d >= 30) throw DecodeError("corrupt deflate stream (distance)");
      size_t back = size_t(kDistBase[d] + in.get(kDistExtra[d]));
      if (back > o) throw DecodeError("corrupt deflate stream (distance)");
      if (o + len > expected) throw DecodeError("too much image data");
      uint8_t* q = out.data() + o;
      for (int i = 0; i < len; i++) q[i] = q[i - back];
      o += len;
    }
  }
  if (o != expected) throw DecodeError("not enough image data");
  in.get(in.cnt & 7);
  uint32_t sum = 0;
  for (int i = 0; i < 4; i++) sum = (sum << 8) | uint32_t(in.get(8));
  if (sum != adler32(out.data(), out.size()))
    throw DecodeError("Adler-32 mismatch in the image data");
  return out;
}

// ---------------------------------------------------------------------- PNG

struct Header {
  uint32_t width = 0, height = 0;
  int depth = 0, ctype = 0, interlace = 0;
  int samples = 0;          // per pixel in the file
  uint8_t palette[256][3];
  int n_palette = 0;
  uint8_t palette_alpha[256];
  int n_trns = -1;          // palette entries with an alpha, -1 no tRNS
  uint16_t trns_color[3] = {0, 0, 0};
};

const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                          {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                          {0, 1, 1, 2}};

size_t row_bytes(const Header& h, uint64_t w) {
  return size_t((w * h.samples * h.depth + 7) / 8);
}

void unfilter(uint8_t* cur, const uint8_t* prev, const uint8_t* raw,
              size_t n, int bpp, int type) {
  // cur and prev have bpp zero bytes before index 0
  switch (type) {
    case 0:
      std::memcpy(cur, raw, n);
      break;
    case 1:
      for (size_t x = 0; x < n; x++) cur[x] = uint8_t(raw[x] + cur[x - bpp]);
      break;
    case 2:
      for (size_t x = 0; x < n; x++) cur[x] = uint8_t(raw[x] + prev[x]);
      break;
    case 3:
      for (size_t x = 0; x < n; x++)
        cur[x] = uint8_t(raw[x] + ((cur[x - bpp] + prev[x]) >> 1));
      break;
    case 4:
      for (size_t x = 0; x < n; x++) {
        int a = cur[x - bpp], b = prev[x], c = prev[x - bpp];
        int pa = b > c ? b - c : c - b;            // |p - a|, p = a + b - c
        int pb = a > c ? a - c : c - a;            // |p - b|
        int pc = a + b - 2 * c;                    // |p - c|
        pc = pc < 0 ? -pc : pc;
        int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        cur[x] = uint8_t(raw[x] + pred);
      }
      break;
    default:
      throw DecodeError("bad row filter " + std::to_string(type));
  }
}

// One row of `w` file pixels -> output pixels x0, x0 + dx, ... of row y.
void expand_row(const Header& h, const uint8_t* row, uint32_t w, Image* img,
                uint32_t y, uint32_t x0, uint32_t dx) {
  const int ch = img->channels, sb = img->bytes;
  uint8_t* out8 = img->data.data() + (size_t(y) * img->width) * ch * sb;
  uint16_t* out16 = reinterpret_cast<uint16_t*>(out8);
  const int d = h.depth;
  auto sample = [&](uint32_t i, int k) -> uint32_t {
    uint64_t idx = uint64_t(i) * h.samples + k;
    if (d == 16) return (uint32_t(row[2 * idx]) << 8) | row[2 * idx + 1];
    if (d == 8) return row[idx];
    uint64_t bit = idx * d;
    return (row[bit >> 3] >> (8 - d - (bit & 7))) & ((1u << d) - 1);
  };
  const uint32_t full = d == 16 ? 0xFFFF : 0xFF;
  for (uint32_t i = 0; i < w; i++) {
    size_t o = size_t(x0 + i * dx) * ch;
    uint32_t v[4];
    switch (h.ctype) {
      case 0:
        v[0] = sample(i, 0);
        if (d < 8) v[0] *= 255 / ((1u << d) - 1);
        break;
      case 2:
        for (int k = 0; k < 3; k++) v[k] = sample(i, k);
        if (ch == 4) {
          uint32_t m = d == 16 ? 0xFFFF : 0xFF;
          bool t = v[0] == (h.trns_color[0] & m) &&
                   v[1] == (h.trns_color[1] & m) &&
                   v[2] == (h.trns_color[2] & m);
          v[3] = t ? 0 : full;
        }
        break;
      case 3: {
        uint32_t p = sample(i, 0);
        for (int k = 0; k < 3; k++)
          v[k] = p < uint32_t(h.n_palette) ? h.palette[p][k] : 0;
        if (ch == 4) v[3] = p < uint32_t(h.n_trns) ? h.palette_alpha[p] : 255;
        break;
      }
      case 4:
        v[0] = v[1] = v[2] = sample(i, 0);
        v[3] = sample(i, 1);
        break;
      default:
        for (int k = 0; k < 4; k++) v[k] = sample(i, k);
    }
    if (sb == 2)
      for (int k = 0; k < ch; k++) out16[o + k] = uint16_t(v[k]);
    else
      for (int k = 0; k < ch; k++) out8[o + k] = uint8_t(v[k]);
  }
}

}  // namespace

void decode_png(const uint8_t* p, size_t n, bool header_only, Image* out) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (n < 8 || std::memcmp(p, sig, 8))
    throw DecodeError("not a PNG file");
  Header h;
  std::vector<std::pair<const uint8_t*, size_t>> idat;
  size_t idat_bytes = 0, pos = 8;
  bool ihdr = false, iend = false;
  int orientation = 1;
  while (!iend) {
    if (pos + 12 > n) throw DecodeError("truncated (no IEND chunk)");
    uint32_t len = be32(p + pos);
    const uint8_t* type = p + pos + 4;
    const uint8_t* body = p + pos + 8;
    std::string name(reinterpret_cast<const char*>(type), 4);
    if (len > 0x7FFFFFFFu || n - pos - 12 < len)
      throw DecodeError("truncated (chunk " + name + " runs past the end)");
    if (!header_only && crc32(type, len + 4) != be32(body + len))
      throw DecodeError("CRC error in chunk " + name);
    pos += 12 + size_t(len);
    if (!ihdr && name != "IHDR") throw DecodeError("no IHDR chunk first");
    if (name == "IHDR") {
      if (ihdr || len != 13) throw DecodeError("bad IHDR chunk");
      ihdr = true;
      h.width = be32(body);
      h.height = be32(body + 4);
      h.depth = body[8];
      h.ctype = body[9];
      h.interlace = body[12];
      const int d = h.depth;
      bool ok = h.width && h.height && h.width <= 0x7FFFFFFFu &&
                h.height <= 0x7FFFFFFFu && body[10] == 0 && body[11] == 0 &&
                h.interlace <= 1;
      switch (h.ctype) {
        case 0: ok &= d == 1 || d == 2 || d == 4 || d == 8 || d == 16; break;
        case 3: ok &= d == 1 || d == 2 || d == 4 || d == 8; break;
        case 2: case 4: case 6: ok &= d == 8 || d == 16; break;
        default: ok = false;
      }
      if (!ok)
        throw DecodeError("bad IHDR (colour type " + std::to_string(h.ctype) +
                          ", bit depth " + std::to_string(d) + ")");
      h.samples = h.ctype == 2 ? 3 : h.ctype == 4 ? 2 : h.ctype == 6 ? 4 : 1;
    } else if (name == "PLTE") {
      if (len % 3 || len == 0 || len > 768 || h.n_palette || !idat.empty())
        throw DecodeError("bad PLTE chunk");
      h.n_palette = int(len / 3);
      std::memcpy(h.palette, body, len);
    } else if (name == "tRNS") {
      if (h.ctype == 3) {
        if (len > uint32_t(h.n_palette)) throw DecodeError("bad tRNS chunk");
        h.n_trns = int(len);
        std::memcpy(h.palette_alpha, body, len);
      } else if (h.ctype == 0 && len == 2) {
        h.n_trns = 0;   // grey: cv2 keeps one channel and ignores it
      } else if (h.ctype == 2 && len == 6) {
        h.n_trns = 0;
        for (int k = 0; k < 3; k++)
          h.trns_color[k] = uint16_t((body[2 * k] << 8) | body[2 * k + 1]);
      }
    } else if (name == "eXIf") {
      orientation = exif_orientation(body, len);
    } else if (name == "IDAT") {
      idat.emplace_back(body, len);
      idat_bytes += len;
    } else if (name == "IEND") {
      iend = true;
    } else if (!(type[0] & 0x20)) {
      throw DecodeError("unknown critical chunk " + name);
    }
  }
  if (idat.empty()) throw DecodeError("no IDAT chunk");
  if (h.ctype == 3 && !h.n_palette) throw DecodeError("no PLTE chunk");
  out->height = int(h.height);
  out->width = int(h.width);
  out->channels = h.ctype == 0 ? 1
                  : (h.ctype == 2 || h.ctype == 3) ? (h.n_trns >= 0 ? 4 : 3)
                                                   : 4;
  out->bytes = h.depth == 16 ? 2 : 1;
  out->orientation = orientation;
  uint64_t total = uint64_t(h.width) * h.height * out->channels * out->bytes;
  if (total > kMaxImageBytes) throw DecodeError("image too large");
  if (header_only) return;

  std::vector<int> passes;
  if (h.interlace)
    for (int i = 0; i < 7; i++) passes.push_back(i);
  else
    passes.push_back(-1);
  size_t expected = 0;
  for (int pi : passes) {
    uint64_t x0 = pi < 0 ? 0 : kAdam7[pi][0], y0 = pi < 0 ? 0 : kAdam7[pi][1];
    uint64_t dx = pi < 0 ? 1 : kAdam7[pi][2], dy = pi < 0 ? 1 : kAdam7[pi][3];
    uint64_t pw = h.width > x0 ? (h.width - x0 + dx - 1) / dx : 0;
    uint64_t ph = h.height > y0 ? (h.height - y0 + dy - 1) / dy : 0;
    if (pw && ph) expected += size_t(ph * (1 + row_bytes(h, pw)));
  }
  std::vector<uint8_t> z(idat_bytes);
  size_t off = 0;
  for (auto& c : idat) {
    std::memcpy(z.data() + off, c.first, c.second);
    off += c.second;
  }
  std::vector<uint8_t> raw = zlib_inflate(z.data(), z.size(), expected);
  out->data.assign(size_t(total), 0);
  const int bpp = std::max(1, h.samples * h.depth / 8);
  const uint8_t* r = raw.data();
  for (int pi : passes) {
    uint32_t x0 = pi < 0 ? 0 : kAdam7[pi][0], y0 = pi < 0 ? 0 : kAdam7[pi][1];
    uint32_t dx = pi < 0 ? 1 : kAdam7[pi][2], dy = pi < 0 ? 1 : kAdam7[pi][3];
    uint32_t pw = h.width > x0 ? (h.width - x0 + dx - 1) / dx : 0;
    uint32_t ph = h.height > y0 ? (h.height - y0 + dy - 1) / dy : 0;
    if (!pw || !ph) continue;
    size_t rb = row_bytes(h, pw);
    std::vector<uint8_t> a(rb + bpp, 0), b(rb + bpp, 0);
    uint8_t *cur = a.data() + bpp, *prev = b.data() + bpp;
    for (uint32_t y = 0; y < ph; y++) {
      unfilter(cur, prev, r + 1, rb, bpp, r[0]);
      r += 1 + rb;
      expand_row(h, cur, pw, out, y0 + y * dy, x0, dx);
      std::swap(cur, prev);
    }
  }
}

}  // namespace wn
