/* PNG scanline unfiltering (PNG 1.2, section 6), for the port's PNG reader
 * (nvblox_mindmap_torch/data/item_io.py). Host C, plain C entry point,
 * built with the system C compiler at first use and loaded with ctypes.
 *
 * The reader inflates the IDAT stream with zlib; what is left is a filter
 * byte before each row and, for the Sub, Average and Paeth filters, a
 * dependency on the reconstructed byte bpp to the left: a serial walk along
 * every row, which numpy cannot vectorize and Python walks ~100x slower.
 */
#include <stdint.h>
#include <stdlib.h>

static int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

/* raw: height rows of (1 filter byte + rowbytes); out: height * rowbytes.
 * Returns 0, or 1 + the first row whose filter type is not 0-4. */
int png_unfilter(const uint8_t* raw, uint8_t* out, int64_t height,
                 int64_t rowbytes, int bpp) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* f = raw + y * (rowbytes + 1);
    const int type = f[0];
    ++f;
    uint8_t* r = out + y * rowbytes;
    const uint8_t* u = y > 0 ? r - rowbytes : 0;
    int64_t x;
    switch (type) {
      case 0:
        for (x = 0; x < rowbytes; ++x) r[x] = f[x];
        break;
      case 1:
        for (x = 0; x < rowbytes; ++x)
          r[x] = (uint8_t)(f[x] + (x >= bpp ? r[x - bpp] : 0));
        break;
      case 2:
        for (x = 0; x < rowbytes; ++x) r[x] = (uint8_t)(f[x] + (u ? u[x] : 0));
        break;
      case 3:
        for (x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? r[x - bpp] : 0;
          const int b = u ? u[x] : 0;
          r[x] = (uint8_t)(f[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? r[x - bpp] : 0;
          const int b = u ? u[x] : 0;
          const int c = (u && x >= bpp) ? u[x - bpp] : 0;
          r[x] = (uint8_t)(f[x] + paeth(a, b, c));
        }
        break;
      default:
        return (int)(1 + y);
    }
  }
  return 0;
}
