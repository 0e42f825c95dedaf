// reve_core — PNG scanline unfiltering for the filters that run serially.
//
// A PNG scanline's Average (3) and Paeth (4) filters predict each byte from
// the byte bpp before it in the same, already unfiltered row, so a row is a
// chain that numpy cannot vectorise.  io/png.py unfilters None, Sub and Up
// in numpy and hands these two to this loop, one row a call.
//
// No external dependencies; C++17; C ABI at the bottom.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// Unfilter one scanline of `n` bytes: `cur` the filtered bytes, `prev` the
// unfiltered row above (zeros for the first row of an image or pass), `out`
// the result; `bpp` the bytes of a whole pixel (1 below 8 bits a sample).
// Returns 0, or -1 for a filter type other than Average or Paeth.
int rc_png_unfilter_row(int filter, const uint8_t* cur, const uint8_t* prev,
                        uint8_t* out, long n, long bpp) {
  if (filter == 3) {
    for (long i = 0; i < n; ++i) {
      const int a = i >= bpp ? out[i - bpp] : 0;
      out[i] = static_cast<uint8_t>(cur[i] + ((a + prev[i]) >> 1));
    }
    return 0;
  }
  if (filter == 4) {
    for (long i = 0; i < n; ++i) {
      const int a = i >= bpp ? out[i - bpp] : 0;
      const int c = i >= bpp ? prev[i - bpp] : 0;
      out[i] = static_cast<uint8_t>(cur[i] + paeth(a, prev[i], c));
    }
    return 0;
  }
  return -1;
}

}  // extern "C"
