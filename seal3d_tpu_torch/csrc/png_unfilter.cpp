// Scanline reconstruction of a non-interlaced 8-bit PNG (the PNG
// specification, section 9: filter method 0). The Sub, Average and Paeth
// filters run in sequence along a row and Up and Paeth read the row above,
// so this is a byte loop; data/provider.py parses the file, inflates it with
// zlib and calls png_unfilter on the inflated stream. Built with g++ at
// first use (runtime/build.py load_host_library).

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

// data: h rows of 1 + row_bytes bytes (the filter type, then the filtered
// bytes); out: h rows of row_bytes reconstructed bytes; bpp: bytes per
// pixel (1 gray, 3 RGB, 4 RGBA). Returns -1, or the first row whose filter
// type is not 0-4 (out is then incomplete).
extern "C" int64_t png_unfilter(const uint8_t* data, uint8_t* out, int64_t h,
                                int64_t row_bytes, int64_t bpp) {
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* src = data + r * (row_bytes + 1);
    const uint8_t filter = src[0];
    ++src;
    uint8_t* dst = out + r * row_bytes;
    const uint8_t* up = r > 0 ? dst - row_bytes : nullptr;
    switch (filter) {
      case 0:
        for (int64_t i = 0; i < row_bytes; ++i) dst[i] = src[i];
        break;
      case 1:
        for (int64_t i = 0; i < row_bytes; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < row_bytes; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return r;
    }
  }
  return -1;
}
