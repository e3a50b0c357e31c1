// PNG scanline unfiltering for io/png.py: its IDAT stream is inflated with
// zlib and the filtered scanlines are handed here.  The routine itself is
// native/png_unfilter.h, which native/loader.cc shares.

#include "png_unfilter.h"

extern "C" {

// Returns 0, or -(y + 1) when row y names an unknown filter type.
int mmt_png_unfilter(const uint8_t* raw, uint8_t* out, int n_rows, int row_bytes,
                     int bpp) {
  return mmt_png::unfilter(raw, out, n_rows, row_bytes, bpp);
}

}  // extern "C"
