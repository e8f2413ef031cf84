// Shared declarations of the port's native library (see __init__.py).
#pragma once

#include <cstdint>
#include <stdexcept>
#include <string>
#include <vector>

namespace wn {

// A decode error; the C entry points turn it into a message for Python,
// which raises ValueError with the file's name.
struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// A decoded image: samples as stored, row-major (height, width, channels),
// 1 or 2 bytes per sample (host order), channel order grey, RGB or RGBA.
struct Image {
  int height = 0, width = 0, channels = 0, bytes = 1;
  int orientation = 1;   // EXIF orientation 1-8 (1 when the file has none)
  std::vector<uint8_t> data;
};

// Largest decoded size accepted, in bytes (guards allocations made from a
// corrupt header).
constexpr uint64_t kMaxImageBytes = uint64_t(1) << 30;

// PNG and JPEG: parse `n` bytes; with `header_only` stop after the header
// (dimensions, channels, orientation) and leave `data` empty.
void decode_png(const uint8_t* p, size_t n, bool header_only, Image* out);
void decode_jpeg(const uint8_t* p, size_t n, bool header_only, Image* out);

// The Orientation tag (0x0112) of IFD0 of a TIFF-structured EXIF block
// (starting at its byte-order mark); 1 when absent or malformed.
int exif_orientation(const uint8_t* p, size_t n);

}  // namespace wn
