// PNG scanline unfiltering (the five filter types of the PNG specification,
// section 9: None, Sub, Up, Average, Paeth) for utils/image_io.py.
//
// Paeth and Average depend on the byte just reconstructed to their left, so
// each row is a sequential scan: a few milliseconds here for a 1024x1024 RGB
// image, against about a second for the same loop in NumPy.
//
// C interface (ctypes):
//   int png_unfilter(const uint8_t* src, uint8_t* dst, int64_t height,
//                    int64_t stride, int64_t bpp)
//     src: height rows of 1 filter-type byte + stride bytes (the inflated
//     IDAT stream); dst: height * stride bytes; bpp: bytes per complete
//     pixel, at least 1.  Returns 0, or -1 at the first row whose filter
//     type is not 0-4.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

}  // namespace

extern "C" int png_unfilter(const uint8_t* src, uint8_t* dst, int64_t height,
                            int64_t stride, int64_t bpp) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = src + y * (stride + 1);
    uint8_t ftype = in[0];
    ++in;
    uint8_t* out = dst + y * stride;
    const uint8_t* up = y ? out - stride : nullptr;  // the row above, or 0s
    switch (ftype) {
      case 0:
        std::memcpy(out, in, size_t(stride));
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          out[i] = uint8_t(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          out[i] = uint8_t(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0;
          int b = up ? up[i] : 0;
          out[i] = uint8_t(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0;
          int b = up ? up[i] : 0;
          int c = (up && i >= bpp) ? up[i - bpp] : 0;
          out[i] = uint8_t(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}
