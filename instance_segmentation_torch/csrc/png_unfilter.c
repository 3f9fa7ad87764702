// Host helper of the data path: undo the row filters of a PNG image.
//
// Not a port of a TPU kernel and no device code: the JAX package reads its
// PNG frames with OpenCV, which the port does not use. The Average and
// Paeth filters read the byte just written, so a row is a sequential loop;
// in Python it would take seconds a 1024x2048 frame. Built by the host C
// compiler (kernels/build.py) on any machine. The numpy form of the same
// function is utils/png.py:unfilter_numpy; tests/test_torch_png.py holds
// the two equal on rows of all five filter types at 1-4 bytes a pixel, and
// tests/test_torch_on_card.py does with this file built on the card's host.
//
// data:   height rows of one filter-type byte and rowbytes filtered bytes
// out:    height rows of rowbytes bytes
// bpp:    bytes of one pixel (the distance the Sub/Average/Paeth filters
//         look back)
// Returns 0, or 1 + the filter type of the first row whose type is not
// 0..4.

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

static inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

int iseg_png_unfilter(const uint8_t* data, int height, int rowbytes, int bpp,
                      uint8_t* out) {
    for (int r = 0; r < height; ++r) {
        const uint8_t* src = data + (size_t)r * (rowbytes + 1);
        const int type = src[0];
        ++src;
        uint8_t* row = out + (size_t)r * rowbytes;
        const uint8_t* up = r > 0 ? row - rowbytes : NULL;
        switch (type) {
        case 0:
            for (int i = 0; i < rowbytes; ++i) row[i] = src[i];
            break;
        case 1:
            for (int i = 0; i < rowbytes; ++i)
                row[i] = (uint8_t)(src[i] + (i >= bpp ? row[i - bpp] : 0));
            break;
        case 2:
            for (int i = 0; i < rowbytes; ++i) row[i] = (uint8_t)(src[i] + (up ? up[i] : 0));
            break;
        case 3:
            for (int i = 0; i < rowbytes; ++i) {
                int a = i >= bpp ? row[i - bpp] : 0, b = up ? up[i] : 0;
                row[i] = (uint8_t)(src[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int i = 0; i < rowbytes; ++i) {
                int a = i >= bpp ? row[i - bpp] : 0, b = up ? up[i] : 0;
                int c = (up && i >= bpp) ? up[i - bpp] : 0;
                row[i] = (uint8_t)(src[i] + paeth(a, b, c));
            }
            break;
        default:
            return 1 + type;
        }
    }
    return 0;
}
