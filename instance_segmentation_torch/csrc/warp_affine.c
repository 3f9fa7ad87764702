// Host helper of the data path: an affine warp of a uint8 image with
// bilinear taps and a constant border, as OpenCV 5.0's
// cv2.warpAffine(img, M, (ow, oh), flags=INTER_LINEAR,
// borderMode=BORDER_CONSTANT, borderValue=...) computes it.
//
// Not a port of a TPU kernel and no device code: the JAX package's random
// resize and rotation call OpenCV, which the port does not use. In numpy
// the same function takes ~170 ms a 512x1024x3 frame. Built by the host C
// compiler (kernels/build.py) on any machine. Its numpy form is
// utils/image.py:warp_affine_linear_numpy; tests/test_torch_augment.py
// holds both to cv2.warpAffine bit for bit, and chip_smoke.py holds the
// two equal on the card's host.
//
// m:       the inverse map (destination -> source), float32 [6]
// border:  the border value of each of the c channels
// lanes:   output columns OpenCV warps per vector step; the columns past
//          the last full step are warped by its scalar loop, which
//          computes the source coordinate in another order
//
// OpenCV's order of operations, each float32 with one rounding, fma a
// fused multiply-add:
//   vector columns  sx = fma(m0, x, y*m1 + m2)
//   scalar columns  sx = fma(x, m0, y*m1) + m2        (sy alike)
//   ix = floor(sx), ax = sx - ix, p.. the four taps (border outside)
//   f0 = fma(ax, p01 - p00, p00), f1 = fma(ax, p11 - p10, p10)
//   f  = fma(ay, f1 - f0, f0), rounded half to even and saturated.
// fma32 below is the float64 product and sum rounded once to float32:
// exact wherever the float64 sum is (always, for the taps' fma), and
// the numpy twin computes the same.

#include <math.h>
#include <stddef.h>
#include <stdint.h>

static inline float fma32(float a, float b, float c) {
    return (float)((double)a * (double)b + (double)c);
}

static inline float tap(const uint8_t* src, int h, int w, int c, long y, long x, int ch,
                        const uint8_t* border) {
    if (y < 0 || y >= h || x < 0 || x >= w) return (float)border[ch];
    return (float)src[((size_t)y * w + (size_t)x) * c + ch];
}

int iseg_warp_affine_linear(const uint8_t* src, int h, int w, int c, const float* m,
                            const uint8_t* border, uint8_t* dst, int oh, int ow, int lanes) {
    if (h <= 0 || w <= 0 || c <= 0 || c > 4 || oh <= 0 || ow <= 0 || lanes <= 0) return 1;
    const int t0 = ow / lanes * lanes;
    for (int y = 0; y < oh; ++y) {
        const float fy = (float)y;
        const float ym1 = fy * m[1], ym4 = fy * m[4];
        const float mx = ym1 + m[2], my = ym4 + m[5];
        uint8_t* row = dst + (size_t)y * ow * c;
        for (int x = 0; x < ow; ++x) {
            const float fx = (float)x;
            float sx, sy;
            if (x < t0) {
                sx = fma32(m[0], fx, mx);
                sy = fma32(m[3], fx, my);
            } else {
                sx = fma32(fx, m[0], ym1) + m[2];
                sy = fma32(fx, m[3], ym4) + m[5];
            }
            const float fx0 = floorf(sx), fy0 = floorf(sy);
            const float ax = sx - fx0, ay = sy - fy0;
            const long ix = (long)fx0, iy = (long)fy0;
            for (int ch = 0; ch < c; ++ch) {
                const float p00 = tap(src, h, w, c, iy, ix, ch, border);
                const float p01 = tap(src, h, w, c, iy, ix + 1, ch, border);
                const float p10 = tap(src, h, w, c, iy + 1, ix, ch, border);
                const float p11 = tap(src, h, w, c, iy + 1, ix + 1, ch, border);
                const float f0 = fma32(ax, p01 - p00, p00);
                const float f1 = fma32(ax, p11 - p10, p10);
                const long v = lrintf(fma32(ay, f1 - f0, f0));
                row[(size_t)x * c + ch] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
            }
        }
    }
    return 0;
}
