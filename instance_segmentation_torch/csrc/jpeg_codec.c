// Host helper of the data path: the arithmetic of a baseline and
// progressive Huffman JPEG codec, 8-bit samples.
//
// Not a port of a TPU kernel and no device code: the JAX package reads and
// writes JPEG frames with OpenCV (libjpeg-turbo through the jpeg-6b API),
// which the port does not use. utils/jpeg.py parses and writes the markers
// and calls these functions for the entropy-coded data, the DCTs, the
// chroma resampling and the colour conversion. Each follows libjpeg-turbo's
// integer arithmetic step for step (jdhuff/jdphuff, jidctint "islow",
// jdsample "fancy" upsampling, jdcolor; jccolor, jcsample, jfdctint,
// jcdctmgr's reciprocal quantisation, jccoefct's dummy blocks, jchuff), so
// decoded pixels equal cv2.imread's and encoded bytes cv2.imwrite's.
// tests/test_torch_jpeg.py holds them so. Built by the host C compiler
// (kernels/build.py) on any machine.

#include <stddef.h>
#include <stdint.h>
#include <string.h>

static const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for a corrupt run past 63 (as libjpeg)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- decoding

typedef struct {
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    uint16_t lut[512];   // 9-bit lookahead: (length << 8) | symbol, 0 = slow path
} dtable_t;

// table: 16 code counts (lengths 1..16), then up to 256 symbols
static int make_dtable(const uint8_t* table, dtable_t* t) {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
        int n = table[l - 1];
        if (p + n > 256) return -1;
        while (n--) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    int nsym = p;
    memcpy(t->vals, table + 16, (size_t)nsym);
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) huffcode[p++] = code++;
        if (code >= (1 << si)) return -1;
        code <<= 1;
        si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
        if (table[l - 1]) {
            t->valoffset[l] = p - huffcode[p];
            p += table[l - 1];
            t->maxcode[l] = huffcode[p - 1];
        } else {
            t->maxcode[l] = -1;
        }
    }
    t->maxcode[17] = 0xFFFFF;
    memset(t->lut, 0, sizeof t->lut);
    p = 0;
    for (int l = 1; l <= 9; l++) {
        for (int i = 0; i < table[l - 1]; i++, p++) {
            int base = huffcode[p] << (9 - l);
            for (int j = 0; j < (1 << (9 - l)); j++)
                t->lut[base + j] = (uint16_t)((l << 8) | t->vals[p]);
        }
    }
    return 0;
}

typedef struct {
    const uint8_t* d;
    int64_t size, pos;   // pos: the next unread byte, or the 0xFF of the marker met
    uint64_t acc;        // bits, most significant first
    int nbits;
    int marker;          // a marker was met: zeros are fed from here on
} breader_t;

static void fill(breader_t* b) {
    while (b->nbits <= 56) {
        uint32_t byte = 0;
        if (!b->marker) {
            if (b->pos >= b->size) {
                b->marker = 1;
            } else if (b->d[b->pos] != 0xFF) {
                byte = b->d[b->pos++];
            } else {
                // FF 00 is a data byte 0xFF; FF..FF 00 too (as libjpeg)
                int64_t q = b->pos + 1;
                while (q < b->size && b->d[q] == 0xFF) q++;
                if (q < b->size && b->d[q] == 0x00) {
                    byte = 0xFF;
                    b->pos = q + 1;
                } else {
                    b->marker = 1;
                }
            }
        }
        b->acc |= (uint64_t)byte << (56 - b->nbits);
        b->nbits += 8;
    }
}

static inline int get_bits(breader_t* b, int n) {
    if (n == 0) return 0;
    if (b->nbits < n) fill(b);
    int v = (int)(b->acc >> (64 - n));
    b->acc <<= n;
    b->nbits -= n;
    return v;
}

static inline int get_bit(breader_t* b) { return get_bits(b, 1); }

static inline int extend(int v, int s) {
    return (s && v < (1 << (s - 1))) ? v + (int)((~0u) << s) + 1 : v;
}

static inline int decode_sym(breader_t* b, const dtable_t* t) {
    if (b->nbits < 16) fill(b);
    int peek = (int)(b->acc >> 48);
    int e = t->lut[peek >> 7];
    if (e) {
        b->acc <<= (e >> 8);
        b->nbits -= (e >> 8);
        return e & 0xFF;
    }
    for (int l = 10; l <= 16; l++) {
        int code = peek >> (16 - l);
        if (code <= t->maxcode[l]) {
            b->acc <<= l;
            b->nbits -= l;
            return t->vals[(t->valoffset[l] + code) & 0xFF];
        }
    }
    // a corrupt code: libjpeg takes symbol 0 after 16 bits
    b->acc <<= 16;
    b->nbits -= 16;
    return 0;
}

// Skip to the next restart marker and past it.
static void restart(breader_t* b) {
    b->acc = 0;
    b->nbits = 0;
    int64_t q = b->pos;
    for (; q + 1 < b->size; q++) {
        if (b->d[q] == 0xFF && b->d[q + 1] != 0x00 && b->d[q + 1] != 0xFF) break;
    }
    if (q + 1 < b->size && b->d[q + 1] >= 0xD0 && b->d[q + 1] <= 0xD7) {
        b->pos = q + 2;
        b->marker = 0;
    } else {
        b->pos = q;
        b->marker = 1;
    }
}

// One scan of a frame.
//   data, size, pos:  the file and the first byte of the scan's entropy data
//   coefs:            int16 coefficients of every component, blocks of 64 in
//                     natural order; component c's block (r, x) starts at
//                     64 * (comp[6c + 0] + r * comp[6c + 1] + x)
//   comp:             for each component of the scan, 6 ints: block offset,
//                     blocks a row of its array, h, v, dc table, ac table
//   tables:           8 Huffman tables of 272 bytes (DC 0..3, AC 0..3)
//   params:           Ss, Se, Ah, Al, restart interval, MCUs across, down
//                     (a scan of one component: its blocks across, down),
//                     1 for a progressive frame
// Returns the offset of the marker that ends the scan, or -1 for a table
// that is not valid.
int64_t iseg_jpeg_decode_scan(const uint8_t* data, int64_t size, int64_t pos,
                              int16_t* coefs, int ncomp, const int32_t* comp,
                              const uint8_t* tables, const int32_t* params) {
    dtable_t dt[8];
    for (int c = 0; c < ncomp; c++) {
        int td = comp[6 * c + 4], ta = comp[6 * c + 5];
        if (make_dtable(tables + 272 * td, &dt[td]) ||
            make_dtable(tables + 272 * (4 + ta), &dt[4 + ta]))
            return -1;
    }
    const int ss = params[0], se = params[1], ah = params[2], al = params[3];
    const int rst = params[4], mcux = params[5], mcuy = params[6];
    const int progressive = params[7];
    breader_t b = {data, size, pos, 0, 0, 0};
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0, togo = rst;
    for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
            if (rst) {
                if (togo == 0) {
                    restart(&b);
                    pred[0] = pred[1] = pred[2] = pred[3] = 0;
                    eobrun = 0;
                    togo = rst;
                }
                togo--;
            }
            for (int c = 0; c < ncomp; c++) {
                const int32_t* cp = comp + 6 * c;
                int bh = ncomp == 1 ? 1 : cp[2], bv = ncomp == 1 ? 1 : cp[3];
                const dtable_t* dct = &dt[cp[4]];
                const dtable_t* act = &dt[4 + cp[5]];
                for (int by = 0; by < bv; by++) {
                    for (int bx = 0; bx < bh; bx++) {
                        int r = my * bv + by, x = mx * bh + bx;
                        int16_t* blk = coefs + 64 * ((int64_t)cp[0] + (int64_t)r * cp[1] + x);
                        if (!progressive) {
                            int s = decode_sym(&b, dct);
                            pred[c] += extend(get_bits(&b, s), s);
                            blk[0] = (int16_t)pred[c];
                            for (int k = 1; k < 64; k++) {
                                int rs = decode_sym(&b, act);
                                int rr = rs >> 4;
                                s = rs & 15;
                                if (s) {
                                    k += rr;
                                    blk[kNatural[k]] = (int16_t)extend(get_bits(&b, s), s);
                                } else {
                                    if (rr != 15) break;
                                    k += 15;
                                }
                            }
                        } else if (ss == 0) {
                            if (ah == 0) {
                                int s = decode_sym(&b, dct);
                                pred[c] += extend(get_bits(&b, s), s);
                                blk[0] = (int16_t)(pred[c] * (1 << al));
                            } else if (get_bit(&b)) {
                                blk[0] = (int16_t)(blk[0] | (1 << al));
                            }
                        } else if (ah == 0) {
                            if (eobrun > 0) {
                                eobrun--;
                                continue;
                            }
                            for (int k = ss; k <= se; k++) {
                                int rs = decode_sym(&b, act);
                                int rr = rs >> 4, s = rs & 15;
                                if (s) {
                                    k += rr;
                                    blk[kNatural[k]] =
                                        (int16_t)(extend(get_bits(&b, s), s) * (1 << al));
                                } else if (rr == 15) {
                                    k += 15;
                                } else {
                                    eobrun = 1 << rr;
                                    if (rr) eobrun += get_bits(&b, rr);
                                    eobrun--;
                                    break;
                                }
                            }
                        } else {
                            const int p1 = 1 << al, m1 = -1 * (1 << al);
                            int k = ss;
                            if (eobrun == 0) {
                                for (; k <= se; k++) {
                                    int rs = decode_sym(&b, act);
                                    int rr = rs >> 4, s = rs & 15;
                                    if (s) {
                                        s = get_bit(&b) ? p1 : m1;
                                    } else if (rr != 15) {
                                        eobrun = 1 << rr;
                                        if (rr) eobrun += get_bits(&b, rr);
                                        break;
                                    }
                                    do {
                                        int16_t* coef = blk + kNatural[k];
                                        if (*coef != 0) {
                                            if (get_bit(&b) && (*coef & p1) == 0)
                                                *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
                                        } else if (--rr < 0) {
                                            break;
                                        }
                                        k++;
                                    } while (k <= se);
                                    if (s) blk[kNatural[k]] = (int16_t)s;
                                }
                            }
                            if (eobrun > 0) {
                                for (; k <= se; k++) {
                                    int16_t* coef = blk + kNatural[k];
                                    if (*coef != 0 && get_bit(&b) && (*coef & p1) == 0)
                                        *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
                                }
                                eobrun--;
                            }
                        }
                    }
                }
            }
        }
    }
    // the offset of the marker that ends the scan
    int64_t q = b.pos;
    while (q + 1 < size && !(data[q] == 0xFF && data[q + 1] != 0x00 && data[q + 1] != 0xFF)) q++;
    return q;
}

// islow inverse DCT (jidctint.c), constants scaled by 2^13
#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

// The sample of a post-IDCT value: libjpeg's range-limit table, indexed
// by the value masked to 10 bits.
static inline uint8_t idct_limit(int64_t v) {
    int u = (int)(v & 1023);
    if (u < 128) return (uint8_t)(u + 128);
    if (u < 512) return 255;
    if (u < 896) return 0;
    return (uint8_t)(u - 896);
}

static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int64_t stride) {
    int64_t ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t* ip = in + c;
        const uint16_t* qp = q + c;
        int64_t* wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
            int64_t dc = ((int64_t)ip[0] * qp[0]) * (1 << PASS1_BITS);
            for (int i = 0; i < 8; i++) wp[8 * i] = dc;
            continue;
        }
        int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)ip[0] * qp[0];
        z3 = (int64_t)ip[32] * qp[32];
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = (int64_t)ip[56] * qp[56];
        tmp1 = (int64_t)ip[40] * qp[40];
        tmp2 = (int64_t)ip[24] * qp[24];
        tmp3 = (int64_t)ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        wp[0] = (int32_t)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
        wp[56] = (int32_t)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
        wp[8] = (int32_t)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
        wp[48] = (int32_t)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
        wp[16] = (int32_t)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
        wp[40] = (int32_t)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
        wp[24] = (int32_t)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
        wp[32] = (int32_t)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
    }
    for (int r = 0; r < 8; r++) {
        const int64_t* wp = ws + 8 * r;
        uint8_t* op = out + r * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
            uint8_t v = idct_limit(DESCALE(wp[0], PASS1_BITS + 3));
            for (int i = 0; i < 8; i++) op[i] = v;
            continue;
        }
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = (wp[0] + wp[4]) * (1 << CONST_BITS);
        int64_t tmp1 = (wp[0] - wp[4]) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = CONST_BITS + PASS1_BITS + 3;
        op[0] = idct_limit(DESCALE(tmp10 + tmp3, n));
        op[7] = idct_limit(DESCALE(tmp10 - tmp3, n));
        op[1] = idct_limit(DESCALE(tmp11 + tmp2, n));
        op[6] = idct_limit(DESCALE(tmp11 - tmp2, n));
        op[2] = idct_limit(DESCALE(tmp12 + tmp1, n));
        op[5] = idct_limit(DESCALE(tmp12 - tmp1, n));
        op[3] = idct_limit(DESCALE(tmp13 + tmp0, n));
        op[4] = idct_limit(DESCALE(tmp13 - tmp0, n));
    }
}

// Inverse DCT of a component's blocks [rows, cols] into uint8
// [8 * rows, 8 * cols]; qtable is in natural order.
void iseg_jpeg_idct(const int16_t* coefs, int rows, int cols, const uint16_t* qtable,
                    uint8_t* out) {
    int64_t stride = 8 * (int64_t)cols;
    for (int r = 0; r < rows; r++)
        for (int c = 0; c < cols; c++)
            idct_islow(coefs + 64 * ((int64_t)r * cols + c), qtable,
                       out + 8 * r * stride + 8 * c, stride);
}

// Upsample a component plane (in_w x in_h samples of a plane whose rows are
// in_stride apart) by integer factors (fx, fy) to out_w x out_h, as
// libjpeg's jdsample.c: "fancy" triangular filters for 2x1, 1x2 and 2x2
// (2x1 and 2x2 only when in_w > 2), replication otherwise; edges replicate
// the last real sample row and column.
void iseg_jpeg_upsample(const uint8_t* in, int64_t in_stride, int in_w, int in_h, int fx,
                        int fy, uint8_t* out, int out_w, int out_h) {
    const int fancy_h = fx == 2 && in_w > 2;
    for (int oy = 0; oy < out_h; oy++) {
        int iy = oy / fy;
        if (iy >= in_h) iy = in_h - 1;
        const uint8_t* r0 = in + iy * in_stride;
        uint8_t* op = out + (int64_t)oy * out_w;
        if (fy == 2 && (fx == 1 || fancy_h)) {
            // the nearer row and the next nearer (above for an even output row)
            int iy1 = (oy & 1) ? iy + 1 : iy - 1;
            if (iy1 < 0) iy1 = 0;
            if (iy1 > in_h - 1) iy1 = in_h - 1;
            const uint8_t* r1 = in + iy1 * in_stride;
            if (fx == 1) {
                int bias = (oy & 1) ? 2 : 1;
                for (int x = 0; x < out_w; x++) op[x] = (uint8_t)((r0[x] * 3 + r1[x] + bias) >> 2);
            } else {
                // h2v2: column sums, then horizontal triangle with biases 8 and 7
                int last = in_w - 1;
                for (int x = 0; x < out_w; x++) {
                    int ix = x >> 1;
                    int this_s = r0[ix] * 3 + r1[ix];
                    int v;
                    if (x & 1) {
                        if (ix == last) v = (this_s * 4 + 7) >> 4;
                        else v = (this_s * 3 + r0[ix + 1] * 3 + r1[ix + 1] + 7) >> 4;
                    } else {
                        if (ix == 0) v = (this_s * 4 + 8) >> 4;
                        else v = (this_s * 3 + r0[ix - 1] * 3 + r1[ix - 1] + 8) >> 4;
                    }
                    op[x] = (uint8_t)v;
                }
            }
        } else if (fy == 1 && fancy_h) {
            int last = in_w - 1;
            for (int x = 0; x < out_w; x++) {
                int ix = x >> 1;
                int v = r0[ix];
                int w;
                if (x & 1) w = ix == last ? v : (v * 3 + r0[ix + 1] + 2) >> 2;
                else w = ix == 0 ? v : (v * 3 + r0[ix - 1] + 1) >> 2;
                op[x] = (uint8_t)w;
            }
        } else {
            for (int x = 0; x < out_w; x++) {
                int ix = x / fx;
                op[x] = r0[ix];
            }
        }
    }
}

// YCbCr -> RGB (jdcolor.c ycc_rgb_convert): n samples of three planes into
// interleaved RGB.
void iseg_jpeg_ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int64_t n,
                          uint8_t* rgb) {
    int32_t cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
        int64_t x = i - 128;
        cr_r[i] = (int32_t)((91881 * x + 32768) >> 16);    // FIX(1.40200)
        cb_b[i] = (int32_t)((116130 * x + 32768) >> 16);   // FIX(1.77200)
        cr_g[i] = -46802 * x;                              // FIX(0.71414)
        cb_g[i] = -22554 * x + 32768;                      // FIX(0.34414), + ONE_HALF
    }
    for (int64_t i = 0; i < n; i++) {
        int yy = y[i], b = cb[i], r = cr[i];
        int vr = yy + cr_r[r];
        int vg = yy + (int)((cb_g[b] + cr_g[r]) >> 16);
        int vb = yy + cb_b[b];
        rgb[3 * i] = (uint8_t)(vr < 0 ? 0 : vr > 255 ? 255 : vr);
        rgb[3 * i + 1] = (uint8_t)(vg < 0 ? 0 : vg > 255 ? 255 : vg);
        rgb[3 * i + 2] = (uint8_t)(vb < 0 ? 0 : vb > 255 ? 255 : vb);
    }
}

// ---------------------------------------------------------------- encoding

// islow forward DCT (jfdctint.c) of centred samples, in place; the result
// is scaled up by 8.
static void fdct_islow(int32_t* data) {
    int32_t* p = data;
    for (int r = 0; r < 8; r++, p += 8) {
        int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
        int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
        int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
        int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
        int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        p[2] = (int32_t)DESCALE(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
        p[6] = (int32_t)DESCALE(z1 + tmp12 * -FIX_1_847759065, CONST_BITS - PASS1_BITS);
        z1 = tmp4 + tmp7;
        int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp4 *= FIX_0_298631336;
        tmp5 *= FIX_2_053119869;
        tmp6 *= FIX_3_072711026;
        tmp7 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        p[7] = (int32_t)DESCALE(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
        p[5] = (int32_t)DESCALE(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
        p[3] = (int32_t)DESCALE(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
        p[1] = (int32_t)DESCALE(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
    }
    p = data;
    for (int c = 0; c < 8; c++, p++) {
        int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
        int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
        int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
        int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = (int32_t)DESCALE(tmp10 + tmp11, PASS1_BITS);
        p[32] = (int32_t)DESCALE(tmp10 - tmp11, PASS1_BITS);
        int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        p[16] = (int32_t)DESCALE(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
        p[48] = (int32_t)DESCALE(z1 + tmp12 * -FIX_1_847759065, CONST_BITS + PASS1_BITS);
        z1 = tmp4 + tmp7;
        int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp4 *= FIX_0_298631336;
        tmp5 *= FIX_2_053119869;
        tmp6 *= FIX_3_072711026;
        tmp7 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        p[56] = (int32_t)DESCALE(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
        p[40] = (int32_t)DESCALE(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
        p[24] = (int32_t)DESCALE(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
        p[8] = (int32_t)DESCALE(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
    }
}

// jcdctmgr.c compute_reciprocal: the quotient of |x| by a divisor d is
// ((|x| + corr) * recip) >> shift.
typedef struct { uint64_t recip, corr; int shift; } divisor_t;

static divisor_t reciprocal(unsigned d) {
    divisor_t q;
    int b = 31 - __builtin_clz(d);   // flss(d) - 1
    int r = 16 + b;
    uint64_t fq = ((uint64_t)1 << r) / d, fr = ((uint64_t)1 << r) % d;
    uint64_t c = d / 2;
    if (fr == 0) {
        fq >>= 1;
        r--;
    } else if (fr <= d / 2U) {
        c++;
    } else {
        fq++;
    }
    q.recip = fq;
    q.corr = c;
    q.shift = r;
    return q;
}

typedef struct {
    uint8_t* out;
    int64_t cap, n;
    uint64_t acc;   // pending bits, right-aligned
    int nbits;
} bwriter_t;

static inline void put_byte(bwriter_t* w, int v) {
    if (w->n < w->cap) w->out[w->n] = (uint8_t)v;
    w->n++;
}

static inline void put_bits(bwriter_t* w, uint32_t code, int size) {
    w->acc = (w->acc << size) | (code & ((1u << size) - 1));
    w->nbits += size;
    while (w->nbits >= 8) {
        int v = (int)((w->acc >> (w->nbits - 8)) & 0xFF);
        put_byte(w, v);
        if (v == 0xFF) put_byte(w, 0);
        w->nbits -= 8;
    }
}

static void flush_bits(bwriter_t* w) {
    if (w->nbits > 0) put_bits(w, 0x7F, 8 - w->nbits);   // pad with ones
    w->acc = 0;
    w->nbits = 0;
}

typedef struct { uint32_t code[256]; int8_t size[256]; } etable_t;

static void make_etable(const uint8_t* table, etable_t* t) {
    memset(t->size, 0, sizeof t->size);
    int code = 0, p = 0;
    for (int l = 1; l <= 16; l++) {
        for (int i = 0; i < table[l - 1]; i++, p++) {
            int sym = table[16 + p];
            t->code[sym] = (uint32_t)code++;
            t->size[sym] = (int8_t)l;
        }
        code <<= 1;
    }
}

static inline int nbits_of(int v) {
    int a = v < 0 ? -v : v, n = 0;
    while (a) {
        n++;
        a >>= 1;
    }
    return n;
}

static void encode_block(bwriter_t* w, const int16_t* blk, int* last_dc, const etable_t* dc,
                         const etable_t* ac) {
    int t = blk[0] - *last_dc;
    *last_dc = blk[0];
    int n = nbits_of(t);
    put_bits(w, dc->code[n], dc->size[n]);
    if (n) put_bits(w, (uint32_t)(t < 0 ? t - 1 : t), n);
    int run = 0;
    for (int k = 1; k < 64; k++) {
        int v = blk[kNatural[k]];
        if (v == 0) {
            run++;
            continue;
        }
        while (run > 15) {
            put_bits(w, ac->code[0xF0], ac->size[0xF0]);
            run -= 16;
        }
        n = nbits_of(v);
        int rs = (run << 4) + n;
        put_bits(w, ac->code[rs], ac->size[rs]);
        put_bits(w, (uint32_t)(v < 0 ? v - 1 : v), n);
        run = 0;
    }
    if (run > 0) put_bits(w, ac->code[0], ac->size[0]);
}

static inline uint8_t at(const uint8_t* p, int64_t stride, int w, int h, int y, int x) {
    return p[(int64_t)(y < h ? y : h - 1) * stride + (x < w ? x : w - 1)];
}

// Encode interleaved (or grey) 8-bit samples into baseline entropy-coded
// data, as libjpeg-turbo's compressor does with cv2.imwrite's settings:
// YCbCr 4:2:0 (h2v2 downsampling with biases 1, 2) for three channels,
// one component for one; edges replicated to whole blocks; dummy blocks
// of an MCU past the image repeat the DC of the block before them.
//   pix:       uint8 [h, w, channels], RGB for three channels
//   qtables:   two tables of 64 quantisation steps in natural order
//   htables:   4 Huffman tables of 272 bytes: DC 0, AC 0, DC 1, AC 1
//   scratch:   h * w * channels bytes
// Returns the bytes of data written into out, or minus the bytes the data
// needs when that is more than cap.
int64_t iseg_jpeg_encode(const uint8_t* pix, int h, int w, int channels,
                         const uint16_t* qtables, const uint8_t* htables,
                         uint8_t* scratch, uint8_t* out, int64_t cap) {
    const int ncomp = channels == 3 ? 3 : 1;
    const int maxs = ncomp == 3 ? 2 : 1;     // 2x2 luma in colour
    const int mcux = (w + 8 * maxs - 1) / (8 * maxs), mcuy = (h + 8 * maxs - 1) / (8 * maxs);
    // component planes: full-size Y (and Cb, Cr before downsampling)
    int cw[3], ch[3], wib[3], hib[3], hs[3];
    for (int c = 0; c < ncomp; c++) {
        hs[c] = c == 0 ? maxs : 1;
        cw[c] = (w * hs[c] + maxs - 1) / maxs;
        ch[c] = (h * hs[c] + maxs - 1) / maxs;
        wib[c] = (cw[c] + 7) / 8;
        hib[c] = (ch[c] + 7) / 8;
    }
    // colour conversion into full-size planes (jccolor.c rgb_ycc_convert)
    const int64_t npix = (int64_t)h * w;
    uint8_t* full[3];
    for (int c = 0; c < ncomp; c++) full[c] = scratch + c * npix;
    if (ncomp == 3) {
        for (int64_t i = 0; i < npix; i++) {
            int64_t r = pix[3 * i], g = pix[3 * i + 1], b = pix[3 * i + 2];
            full[0][i] = (uint8_t)((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
            full[1][i] = (uint8_t)((-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16);
            full[2][i] = (uint8_t)((32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16);
        }
    } else {
        for (int64_t i = 0; i < npix; i++) full[0][i] = pix[(int64_t)channels * i];
    }
    bwriter_t wr = {out, cap, 0, 0, 0};
    etable_t et[4];
    for (int i = 0; i < 4; i++) make_etable(htables + 272 * i, &et[i]);
    divisor_t dv[2][64];
    for (int t = 0; t < 2; t++)
        for (int i = 0; i < 64; i++) dv[t][i] = reciprocal(8u * qtables[64 * t + i]);
    int last_dc[3] = {0, 0, 0};
    int16_t blocks[6][64];
    int32_t ws[64];
    for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
            int blkn = 0;
            for (int c = 0; c < ncomp; c++) {
                int mw = ncomp == 3 ? hs[c] : 1, mh = mw;
                int blockcnt = mw;
                if (mx == mcux - 1) blockcnt = wib[c] % mw ? wib[c] % mw : mw;
                int last_row = hib[c] % mh ? hib[c] % mh : mh;
                for (int yi = 0; yi < mh; yi++) {
                    if (my < mcuy - 1 || yi < last_row) {
                        for (int bi = 0; bi < blockcnt; bi++) {
                            int by = (my * mh + yi) * 8, bx = (mx * mw + bi) * 8;
                            for (int y = 0; y < 8; y++) {
                                for (int x = 0; x < 8; x++) {
                                    int s;
                                    if (c == 0 || ncomp == 1) {
                                        s = at(full[c], w, w, h, by + y, bx + x);
                                    } else {
                                        // h2v2_downsample of the edge-replicated plane;
                                        // rows past the last downsampled row repeat it
                                        int oy = by + y, ox = bx + x;
                                        if (oy > ch[c] - 1) oy = ch[c] - 1;
                                        int y0 = 2 * oy, x0 = 2 * ox;
                                        s = (at(full[c], w, w, h, y0, x0) + at(full[c], w, w, h, y0, x0 + 1) +
                                             at(full[c], w, w, h, y0 + 1, x0) +
                                             at(full[c], w, w, h, y0 + 1, x0 + 1) + 1 + (ox & 1)) >> 2;
                                    }
                                    ws[8 * y + x] = s - 128;
                                }
                            }
                            fdct_islow(ws);
                            const divisor_t* d = dv[c == 0 ? 0 : 1];
                            for (int i = 0; i < 64; i++) {
                                int64_t t = ws[i];
                                int neg = t < 0;
                                uint64_t a = (uint64_t)(neg ? -t : t);
                                int64_t qv = (int64_t)(((a + d[i].corr) * d[i].recip) >> d[i].shift);
                                blocks[blkn + bi][i] = (int16_t)(neg ? -qv : qv);
                            }
                        }
                        for (int bi = blockcnt; bi < mw; bi++) {
                            memset(blocks[blkn + bi], 0, sizeof blocks[0]);
                            blocks[blkn + bi][0] = blocks[blkn + bi - 1][0];
                        }
                    } else {
                        for (int bi = 0; bi < mw; bi++) {
                            memset(blocks[blkn + bi], 0, sizeof blocks[0]);
                            blocks[blkn + bi][0] = blocks[blkn - 1][0];
                        }
                    }
                    blkn += mw;
                }
            }
            blkn = 0;
            for (int c = 0; c < ncomp; c++) {
                int nb = ncomp == 3 ? hs[c] * hs[c] : 1;
                int t = c == 0 ? 0 : 1;
                for (int i = 0; i < nb; i++, blkn++)
                    encode_block(&wr, blocks[blkn], &last_dc[c], &et[2 * t], &et[2 * t + 1]);
            }
        }
    }
    flush_bits(&wr);
    return wr.n > cap ? -wr.n : wr.n;
}
