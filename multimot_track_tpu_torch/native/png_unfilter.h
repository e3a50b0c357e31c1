// PNG scanline unfiltering (PNG specification, section 9: filter method 0),
// shared by native/png_unfilter.cc (io/png.py's decode) and
// native/loader.cc (the threaded KITTI loader).
//
// Average (3) and Paeth (4) predict a byte from the already reconstructed
// byte to its left, so the rows are reversed one byte after another.
//
// raw:  n_rows x (1 + row_bytes) bytes, each row led by its filter type
// out:  n_rows x row_bytes reconstructed bytes
// bpp:  bytes per complete pixel (at least 1), the distance to "a"

#pragma once

#include <cstddef>
#include <cstdint>
#include <cstdlib>

namespace mmt_png {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

// Returns 0, or -(y + 1) when row y names an unknown filter type.
inline int unfilter(const uint8_t* raw, uint8_t* out, int n_rows, int row_bytes, int bpp) {
  for (int y = 0; y < n_rows; ++y) {
    const uint8_t* in = raw + size_t(y) * (row_bytes + 1);
    const uint8_t ft = in[0];
    ++in;
    uint8_t* cur = out + size_t(y) * row_bytes;
    const uint8_t* up = y > 0 ? cur - row_bytes : nullptr;
    for (int x = 0; x < row_bytes; ++x) {
      const int a = x >= bpp ? cur[x - bpp] : 0;
      const int b = up ? up[x] : 0;
      const int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int pred;
      switch (ft) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return -(y + 1);
      }
      cur[x] = uint8_t(in[x] + pred);
    }
  }
  return 0;
}

}  // namespace mmt_png
