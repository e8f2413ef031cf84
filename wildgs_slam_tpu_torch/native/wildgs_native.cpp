// The port's native library: PNG and JPEG decoding (png_decode.cpp,
// jpeg_decode.cpp), the EXIF orientation tag, and a binary PLY writer.
// Built with g++ and the C++ standard library alone; no libpng, no
// libjpeg. A plain C interface, loaded with ctypes (which releases the
// GIL during each call, so that decoding in threads runs in parallel).

#include <cstdio>
#include <cstring>

#include "native.h"

namespace wn {

int exif_orientation(const uint8_t* p, size_t n) {
  if (n < 8) return 1;
  bool le = p[0] == 'I' && p[1] == 'I';
  if (!le && !(p[0] == 'M' && p[1] == 'M')) return 1;
  auto u16 = [&](size_t o) -> unsigned {
    return le ? p[o] | (p[o + 1] << 8) : (p[o] << 8) | p[o + 1];
  };
  auto u32 = [&](size_t o) -> uint32_t {
    return le ? u16(o) | (uint32_t(u16(o + 2)) << 16)
              : (uint32_t(u16(o)) << 16) | u16(o + 2);
  };
  if (u16(2) != 42) return 1;
  size_t ifd = u32(4);
  if (ifd > n - 2) return 1;
  unsigned count = u16(ifd);
  for (unsigned i = 0; i < count; i++) {
    size_t e = ifd + 2 + 12 * size_t(i);
    if (e + 12 > n) break;
    if (u16(e) == 0x0112) {
      unsigned v = u16(e + 2) == 3 ? u16(e + 8) : 0;   // SHORT
      return v >= 1 && v <= 8 ? int(v) : 1;
    }
  }
  return 1;
}

}  // namespace wn

namespace {

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
}

// format: 0 either, 1 PNG only, 2 JPEG only
void decode(const uint8_t* p, long n, int format, bool header_only,
            wn::Image* img) {
  bool png = n >= 8 && p[0] == 0x89 && p[1] == 'P';
  if (format == 1 || (format == 0 && png))
    wn::decode_png(p, size_t(n), header_only, img);
  else if (format == 2 || (n >= 2 && p[0] == 0xFF && p[1] == 0xD8))
    wn::decode_jpeg(p, size_t(n), header_only, img);
  else
    throw wn::DecodeError("neither a PNG nor a JPEG file");
}

void fill_info(const wn::Image& img, int* info) {
  info[0] = img.height;
  info[1] = img.width;
  info[2] = img.channels;
  info[3] = img.bytes;
  info[4] = img.orientation;
}

}  // namespace

extern "C" {

// The header of a PNG or JPEG held in `p`: info = height, width, channels,
// bytes per sample, EXIF orientation. Returns 1, or 0 with a message.
int wn_peek(const uint8_t* p, long n, int format, int* info, char* err,
            int errlen) {
  try {
    wn::Image img;
    decode(p, n, format, true, &img);
    fill_info(img, info);
    return 1;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 0;
  }
}

// Decode into `out` (out_bytes = height * width * channels * bytes per
// sample, as wn_peek gave them). Returns 1, or 0 with a message.
int wn_decode(const uint8_t* p, long n, int format, uint8_t* out,
              long out_bytes, int* info, char* err, int errlen) {
  try {
    wn::Image img;
    decode(p, n, format, false, &img);
    fill_info(img, info);
    if (long(img.data.size()) != out_bytes)
      throw wn::DecodeError("output buffer of the wrong size");
    std::memcpy(out, img.data.data(), img.data.size());
    return 1;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 0;
  }
}

// Binary little-endian PLY: data is (n, n_props) row-major float32, one
// `property float <name>` per column. Returns 1 on success.
int wn_write_ply(const char* path, const float* data, long n, int n_props,
                 const char** prop_names) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return 0;
  std::fprintf(fp, "ply\nformat binary_little_endian 1.0\nelement vertex %ld\n",
               n);
  for (int i = 0; i < n_props; i++)
    std::fprintf(fp, "property float %s\n", prop_names[i]);
  std::fprintf(fp, "end_header\n");
  size_t count = size_t(n) * n_props;
  size_t written = std::fwrite(data, sizeof(float), count, fp);
  return (std::fclose(fp) == 0 && written == count) ? 1 : 0;
}

}  // extern "C"
