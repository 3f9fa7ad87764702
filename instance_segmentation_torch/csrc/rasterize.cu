// Kernels K2, K5 and K6: the boundary-point rasterizers of the training loss
// and the min-r2 map of the count-map route.
//
// K2 replaces instance_segmentation_tpu/losses/rasterize_pallas.py
// rasterize_cnt_r2 (_make_kernel): from the packed point list it writes, per
// (image, instance), the u16 sample-count map and the u8 min-r2 map (min
// dy^2 + dx^2 to a sample pixel within max-norm radius 3, else 200), and per
// image the u8 union over instances of cnt > 0. Bit-exact.
//
// K5 replaces rasterize_pallas.py rasterize_nmap (_make_nmap_kernel): per
// image, the sum of the valid samples' inward normals at their clipped
// pixels, the tangent loss's target field (two f32 planes), each pixel's sum
// taken in (instance, sample) order, so equal bit for bit to a sequential
// float32 scatter-add (and to PyTorch's CPU index_add_).
//
// K6 replaces instance_segmentation_tpu/losses/minr2_pallas.py
// minr2_from_cnt (_make_kernel, _axis_min): the same u8 min-r2 map, read
// from an existing u16 count map (the route taken where K2's rule refuses
// the shape, e.g. 1024x2048), with slabs whose instance has no valid sample
// set to 200 whatever their counts hold. Bit-exact: K6 computes K2's
// separable min (column_min_pass, row_min) bytewise, 4 pixels a word.
//
// K2's points arrive pre-clipped: valid samples lie inside the image,
// invalid ones are encoded out of range (y = H, x = W) and are never
// counted. K5 takes the point list, its validity bytes and the normals as
// the loss holds them and clips itself.
//
// What bounds them on the card:
//  * K2 writes B*M*H*W*3 bytes plus the union (1.2 GB at B=8, M=96,
//    512x1024): bytes. Most slots are padding (no valid point): those
//    blocks only store the constants cnt 0 / r2 200, as 16- and 8-byte
//    vector stores. A live slot's tile (16 x 128 pixels plus a 3-pixel halo)
//    counts its points in shared memory with shared atomics (integer, so
//    exact in any order), then runs the separable column/row min there; the
//    union stays in registers across the instance loop.
//  * K5 reads the point list once and writes 2*B*H*W floats (~34 MB at
//    B=8, 512x1024): bytes. Two launches from one C call, no float atomics.
//    Pass 1 bins the valid samples by (image, band of 4 rows) with a stable
//    counting sort local to each warp's chunk of 512 points; pass 2 gives
//    each block one band, zero-fills it in shared memory, adds the band's
//    records chunk by chunk in list order and writes it with 16-byte stores.
//  * K6 reads the live slabs' counts (2 B/px) and writes r2 (1 B/px) for
//    every slab: bytes, most of them the padding slabs' 200s (80 of 96 slabs
//    at 1024x2048). A block per small tile would be bound by the block count
//    instead (98,304 blocks of 16 x 128 at 1024x2048, most storing 2 KB and
//    exiting). So a persistent grid, as many blocks as the SMs hold, walks
//    two lists: fill items, 16 KB of a padding slab stored as 16-byte words
//    of 200s, and live items, bands of 64 x 128 pixels, whose halo (3 rows
//    above and below, once per 64 rows) comes in as 16-byte count vectors
//    turned into flag bytes in shared memory (__vcmpne2, __byte_perm). The
//    separable min then runs on words of 4 pixels: the horizontal pass takes
//    byte windows of neighbouring words and selects o^2 by masks, the
//    vertical pass walks 8 rows a thread with __vaddus4 and __vminu4.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kRadius = 3;
constexpr int kBig = 200;

// ---- K2 ---------------------------------------------------------------------
constexpr int kTileH = 16;                       // rows per block
constexpr int kTileW = 128;                      // columns per block (32 x 4)
constexpr int kHaloH = kTileH + 2 * kRadius;
constexpr int kHaloW = kTileW + 2 * kRadius;
constexpr int kRowsPerPass = kThreads / (kTileW / 4);   // 8
constexpr int kPasses = kTileH / kRowsPerPass;          // 2

// Column pass of the separable min over the tile and its halo rows:
// colmin[rr][cc] = min over |o| <= R of o^2 where flags[rr][cc + R + o] > 0,
// else 200. Neighbours outside the image hold no samples, so they never
// win: the reference's +200 border penalty has the same effect.
__device__ __forceinline__ void column_min_pass(int (*flags)[kHaloW],
                                                uint8_t (*colmin)[kTileW], int tid) {
  for (int i = tid; i < kHaloH * kTileW; i += kThreads) {
    const int rr = i / kTileW, cc = i % kTileW;
    int best = flags[rr][cc + kRadius] > 0 ? 0 : kBig;
    for (int o = 1; o <= kRadius; ++o) {
      if (flags[rr][cc + kRadius - o] > 0 || flags[rr][cc + kRadius + o] > 0)
        best = min(best, o * o);
    }
    colmin[rr][cc] = (uint8_t)best;
  }
}

// Row pass at tile pixel (tr, tc): min over |o| <= R of colmin + o^2
// (values stay <= 200 + 2 R^2 = 218, so u8 holds them).
__device__ __forceinline__ uint8_t row_min(uint8_t (*colmin)[kTileW], int tr, int tc) {
  int best = colmin[tr + kRadius][tc];
  for (int o = 1; o <= kRadius; ++o) {
    best = min(best, (int)colmin[tr + kRadius - o][tc] + o * o);
    best = min(best, (int)colmin[tr + kRadius + o][tc] + o * o);
  }
  return (uint8_t)best;
}

__device__ __forceinline__ uint32_t pack4(const uint8_t v[4]) {
  return (uint32_t)v[0] | ((uint32_t)v[1] << 8) | ((uint32_t)v[2] << 16) |
         ((uint32_t)v[3] << 24);
}

__global__ void __launch_bounds__(kThreads)
cnt_r2_kernel(const int32_t* __restrict__ ys,    // [B, M, P]
              const int32_t* __restrict__ xs,    // [B, M, P]
              const uint8_t* __restrict__ has,   // [B, M]
              int M, int P, int H, int W,
              uint16_t* __restrict__ cnt,        // [B, M, H, W]
              uint8_t* __restrict__ r2,          // [B, M, H, W]
              uint8_t* __restrict__ uni) {       // [B, H, W]
  __shared__ int counts[kHaloH][kHaloW];
  __shared__ uint8_t colmin[kHaloH][kTileW];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x;
  const int lc = (tid % (kTileW / 4)) * 4;       // first of this thread's 4 columns
  const int lr = tid / (kTileW / 4);             // row within a pass
  const bool col_ok = c0 + lc < W;               // W % 4 == 0: all 4 or none
  uint32_t uni_bits = 0;                         // bit 4*pass + j

  for (int m = 0; m < M; ++m) {
    const size_t slab = ((size_t)b * M + m) * H * W;
    if (!has[(size_t)b * M + m]) {
      for (int k = 0; k < kPasses; ++k) {
        const int row = r0 + lr + k * kRowsPerPass;
        if (row < H && col_ok) {
          const size_t o = slab + (size_t)row * W + c0 + lc;
          *reinterpret_cast<uint2*>(cnt + o) = make_uint2(0u, 0u);
          *reinterpret_cast<uint32_t*>(r2 + o) = 0xC8C8C8C8u;   // 4 x 200
        }
      }
      continue;
    }
    for (int i = tid; i < kHaloH * kHaloW; i += kThreads) (&counts[0][0])[i] = 0;
    __syncthreads();
    const size_t pbase = ((size_t)b * M + m) * P;
    for (int p = tid; p < P; p += kThreads) {
      const int py = ys[pbase + p], px = xs[pbase + p];
      const int ly = py - (r0 - kRadius), lx = px - (c0 - kRadius);
      if (py < H && px < W && ly >= 0 && ly < kHaloH && lx >= 0 && lx < kHaloW)
        atomicAdd(&counts[ly][lx], 1);
    }
    __syncthreads();
    column_min_pass(counts, colmin, tid);
    __syncthreads();
    for (int k = 0; k < kPasses; ++k) {
      const int tr = lr + k * kRowsPerPass;
      const int row = r0 + tr;
      uint16_t cv[4];
      uint8_t rv[4];
      for (int j = 0; j < 4; ++j) {
        const int c = counts[tr + kRadius][lc + j + kRadius];
        cv[j] = (uint16_t)c;
        rv[j] = row_min(colmin, tr, lc + j);
        if (c > 0) uni_bits |= 1u << (4 * k + j);
      }
      if (row < H && col_ok) {
        const size_t o = slab + (size_t)row * W + c0 + lc;
        *reinterpret_cast<uint2*>(cnt + o) =
            make_uint2((uint32_t)cv[0] | ((uint32_t)cv[1] << 16),
                       (uint32_t)cv[2] | ((uint32_t)cv[3] << 16));
        *reinterpret_cast<uint32_t*>(r2 + o) = pack4(rv);
      }
    }
    __syncthreads();                             // before counts is zeroed again
  }
  for (int k = 0; k < kPasses; ++k) {
    const int row = r0 + lr + k * kRowsPerPass;
    if (row < H && col_ok) {
      const uint32_t bits = (uni_bits >> (4 * k)) & 0xFu;
      *reinterpret_cast<uint32_t*>(uni + ((size_t)b * H + row) * W + c0 + lc) =
          (bits & 1u) | (((bits >> 1) & 1u) << 8) | (((bits >> 2) & 1u) << 16) |
          (((bits >> 3) & 1u) << 24);
    }
  }
}

// ---- K6 ---------------------------------------------------------------------
// A persistent grid walks two lists of items. A live item is one band of
// kBandH x kBandW pixels of a slab whose instance has samples; a fill item is
// kFillBytes of a padding slab (has == 0), stored as 200s. Each block skips
// the items of the other kind (a byte of `has` read, uniform across it).
constexpr int kBandH = 64;                       // rows of a live item
constexpr int kBandW = 128;                      // columns of a live item: 32 words of 4
constexpr int kBandWords = kBandW / 4;
constexpr int kBandHaloH = kBandH + 2 * kRadius;
constexpr int kFlagPad = 8;                      // flag columns staged each side (>= kRadius,
                                                 // one 16-byte vector of counts)
constexpr int kFlagW = kBandW + 2 * kFlagPad;
constexpr int kRowsPerThread = kBandH / (kThreads / kBandWords);   // vertical pass: 8
constexpr int kFillBytes = 16384;                // a fill item: 4 16-byte stores a thread
constexpr uint32_t kBig4 = 0xC8C8C8C8u;          // 4 x 200
static_assert(kRowsPerThread * (kThreads / kBandWords) == kBandH, "the band's rows split evenly");
static_assert(kFillBytes == 4 * 16 * kThreads, "fill_big: 4 16-byte stores a thread");

// Bytes k..k+3 of the 8 bytes (lo, hi): a __byte_perm selector.
__device__ __forceinline__ uint32_t bytes_from(uint32_t lo, uint32_t hi, int k) {
  return __byte_perm(lo, hi, k | (k + 1) << 4 | (k + 2) << 8 | (k + 3) << 12);
}

// V u16 counts as one vector load: 16 or 8 bytes.
template <int V> struct VecOf;
template <> struct VecOf<8> { using type = uint4; };
template <> struct VecOf<4> { using type = uint2; };
template <int V> using Vec = typename VecOf<V>::type;

// The counts' flag bytes (0xFF where the count is not 0), stored at f.
__device__ __forceinline__ void store_flags(const uint4& q, uint8_t* f) {
  *reinterpret_cast<uint2*>(f) =
      make_uint2(__byte_perm(__vcmpne2(q.x, 0u), __vcmpne2(q.y, 0u), 0x6420),
                 __byte_perm(__vcmpne2(q.z, 0u), __vcmpne2(q.w, 0u), 0x6420));
}

__device__ __forceinline__ void store_flags(const uint2& q, uint8_t* f) {
  *reinterpret_cast<uint32_t*>(f) = __byte_perm(__vcmpne2(q.x, 0u), __vcmpne2(q.y, 0u), 0x6420);
}

// One live item: the band's halo of count flags (out-of-image pixels empty)
// comes in as V-count vector loads; the separable min of K2's
// column_min_pass and row_min then runs on 4 pixels a word, bytewise
// (__byte_perm windows, masks, __vminu4/__vaddus4).
template <int V>
__device__ __forceinline__ void minr2_band(const uint16_t* __restrict__ cnt, int H, int W,
                                           int r0, int c0, uint8_t* __restrict__ out,
                                           uint8_t (*flags)[kFlagW],
                                           uint32_t (*hmin)[kBandWords]) {
  const int tid = threadIdx.x;
  constexpr int kVecs = kFlagW / V;              // count vectors per halo row
  constexpr int kLoads = (kBandHaloH * kVecs + kThreads - 1) / kThreads;
  Vec<V> q[kLoads];                              // every load issued before any is used
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = tid + u * kThreads, rr = i / kVecs, v = i % kVecs;
    const int row = r0 - kRadius + rr, col = c0 - kFlagPad + v * V;
    const bool in = i < kBandHaloH * kVecs && row >= 0 && row < H && col >= 0 &&
                    col < W;                     // W % V == 0
    q[u] = in ? *reinterpret_cast<const Vec<V>*>(cnt + (size_t)row * W + col) : Vec<V>{};
  }
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = tid + u * kThreads;
    if (i < kBandHaloH * kVecs) store_flags(q[u], &flags[i / kVecs][(i % kVecs) * V]);
  }
  __syncthreads();
  // horizontal: min over |o| <= R of o^2 where flagged, else 200 (the larger
  // offsets first, so the nearest flag wins)
  for (int i = tid; i < kBandHaloH * kBandWords; i += kThreads) {
    const int rr = i / kBandWords, w = i % kBandWords;
    const uint32_t* f = reinterpret_cast<const uint32_t*>(flags[rr]) + kFlagPad / 4 + w;
    const uint32_t left = f[-1], mid = f[0], right = f[1];
    uint32_t h = kBig4;
#pragma unroll
    for (int o = kRadius; o >= 1; --o) {
      const uint32_t hit = bytes_from(left, mid, 4 - o) | bytes_from(mid, right, o);
      h = (hit & (0x01010101u * (uint32_t)(o * o))) | (~hit & h);
    }
    hmin[rr][w] = ~mid & h;
  }
  __syncthreads();
  // vertical: min over |o| <= R of hmin + o^2 (at most 200 + 9: no
  // saturation), a thread down kRowsPerThread rows of one word
  const int w = tid % kBandWords, tr0 = (tid / kBandWords) * kRowsPerThread;
  uint32_t h[kRowsPerThread + 2 * kRadius];
#pragma unroll
  for (int i = 0; i < kRowsPerThread + 2 * kRadius; ++i) h[i] = hmin[tr0 + i][w];
  const int col = c0 + 4 * w;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    uint32_t best = h[r + kRadius];
#pragma unroll
    for (int o = 1; o <= kRadius; ++o) {
      const uint32_t add = 0x01010101u * (uint32_t)(o * o);
      best = __vminu4(best, __vaddus4(h[r + kRadius - o], add));
      best = __vminu4(best, __vaddus4(h[r + kRadius + o], add));
    }
    const int row = r0 + tr0 + r;
    if (row < H && col < W)                      // W % 4 == 0: all 4 columns or none
      *reinterpret_cast<uint32_t*>(out + (size_t)row * W + col) = best;
  }
}

// 200s over the bytes [lo, hi) of r2, both multiples of 4: 4-byte stores up
// to the first 16-byte boundary and after the last, 16-byte ones between.
__device__ __forceinline__ void fill_big(uint8_t* __restrict__ r2, size_t lo, size_t hi) {
  const size_t up = (lo + 15) & ~(size_t)15, down = hi & ~(size_t)15;
  const size_t a0 = up < hi ? up : hi;
  const size_t a1 = down > a0 ? down : a0;
  const int tid = threadIdx.x;
  for (size_t x = lo + 4 * tid; x < a0; x += 4 * kThreads)
    *reinterpret_cast<uint32_t*>(r2 + x) = kBig4;
  for (size_t x = a0 + 16 * tid; x < a1; x += 16 * kThreads)
    *reinterpret_cast<uint4*>(r2 + x) = make_uint4(kBig4, kBig4, kBig4, kBig4);
  for (size_t x = a1 + 4 * tid; x < hi; x += 4 * kThreads)
    *reinterpret_cast<uint32_t*>(r2 + x) = kBig4;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
minr2_kernel(const uint16_t* __restrict__ cnt,   // [BM, H, W]
             const uint8_t* __restrict__ has,    // [BM]
             int BM, int H, int W,
             uint8_t* __restrict__ r2) {         // [BM, H, W]
  __shared__ __align__(16) uint8_t flags[kBandHaloH][kFlagW];
  __shared__ uint32_t hmin[kBandHaloH][kBandWords];
  const size_t plane = (size_t)H * W;
  const int bands_w = (W + kBandW - 1) / kBandW;
  const int per_slab = ((H + kBandH - 1) / kBandH) * bands_w;      // live items a slab
  const int fills = (int)((plane + kFillBytes - 1) / kFillBytes);  // fill items a slab
  for (int item = blockIdx.x; item < BM * per_slab; item += gridDim.x) {
    const int slab = item / per_slab;
    if (!has[slab]) continue;                    // uniform across the block
    const int t = item - slab * per_slab;
    minr2_band<V>(cnt + slab * plane, H, W, (t / bands_w) * kBandH, (t % bands_w) * kBandW,
                  r2 + slab * plane, flags, hmin);
  }
  for (int item = blockIdx.x; item < BM * fills; item += gridDim.x) {
    const int slab = item / fills;
    if (has[slab]) continue;
    const size_t lo = (size_t)(item - slab * fills) * kFillBytes;
    const size_t hi = lo + kFillBytes < plane ? lo + kFillBytes : plane;
    fill_big(r2, slab * plane + lo, slab * plane + hi);
  }
}

// ---- K5 ---------------------------------------------------------------------
constexpr int kBandRows = 4;                     // rows of one image per band
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 16;                       // 32-point steps of one chunk
constexpr int kChunk = 32 * kSteps;              // points of one chunk (one warp's)
constexpr int kListCap = 512;                    // band records staged at once
constexpr unsigned kFull = 0xffffffffu;

// Pass 1: each warp reads one chunk of kChunk consecutive points of an image
// in its (instance, sample) order, once, and bins its valid samples by band
// with a stable counting sort local to the chunk: __match_any_sync ranks the
// samples of one band within a 32-point step in lane order, a per-warp
// shared histogram carries the ranks across steps. It writes the chunk's
// records (pixel within the band, n0, n1) grouped by band, in point order
// within a band, and the running end of each band's group.
__global__ void __launch_bounds__(kThreads)
nmap_bin_kernel(const int2* __restrict__ pts,        // [B, MP]: (row, col)
                const uint8_t* __restrict__ valid,   // [B, MP]
                const float2* __restrict__ nrm,      // [B, MP]
                int MP, int H, int W, int nbands, int nchunks,
                int4* __restrict__ recs,             // [B, MP]: chunk c's at c * kChunk
                int* __restrict__ ends) {            // [B, nchunks, nbands]
  extern __shared__ int s_hist[];                    // [kWarps][nbands]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int chunk = blockIdx.x * kWarps + warp;
  if (chunk >= nchunks) return;                      // no block-wide sync follows
  int* hist = s_hist + warp * nbands;
  for (int i = lane; i < nbands; i += 32) hist[i] = 0;
  const int first = chunk * kChunk;
  const size_t base = (size_t)blockIdx.y * MP + first;
  int2 p[kSteps];
  bool ok[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {                 // all loads first
    const int i = s * 32 + lane;
    ok[s] = first + i < MP && valid[base + i];
    p[s] = ok[s] ? pts[base + i] : make_int2(0, 0);
  }
  __syncwarp();                                      // the zeroed histogram
  int band[kSteps], pix[kSteps], rank[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int y = min(max(p[s].x, 0), H - 1), x = min(max(p[s].y, 0), W - 1);
    band[s] = ok[s] ? y / kBandRows : -1;
    pix[s] = (y % kBandRows) * W + x;
    const unsigned grp = __match_any_sync(kFull, band[s]);
    const int leader = __ffs(grp) - 1;
    int before = 0;
    if (ok[s] && lane == leader) {
      before = hist[band[s]];
      hist[band[s]] = before + __popc(grp);
    }
    rank[s] = __shfl_sync(kFull, before, leader) + __popc(grp & ((1u << lane) - 1u));
    __syncwarp();
  }
  // the bands' starts within the chunk: an exclusive scan of the histogram
  const int per = (nbands + 31) / 32;
  int sum = 0;
  for (int k = 0; k < per; ++k) {
    const int i = lane * per + k;
    if (i < nbands) sum += hist[i];
  }
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  int run = incl - sum;
  int* end_row = ends + ((size_t)blockIdx.y * nchunks + chunk) * nbands;
  for (int k = 0; k < per; ++k) {
    const int i = lane * per + k;
    if (i < nbands) {
      const int c = hist[i];
      hist[i] = run;
      run += c;
      end_row[i] = run;
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    if (band[s] < 0) continue;
    const float2 n = nrm[base + s * 32 + lane];
    recs[base + hist[band[s]] + rank[s]] =
        make_int4(pix[s], __float_as_int(n.x), __float_as_int(n.y), 0);
  }
}

// Pass 2: one block per (band, image). It finds the band's records in every
// chunk (a block scan of their counts, in chunk order), zero-fills the band's
// two planes in shared memory, stages the records in list order and adds
// them without float atomics: warp w owns the pixels whose 4-pixel group is
// w mod kWarps and walks the list in order, 32 records a step; the records of
// one pixel within a step (__match_any_sync) are added by their first lane
// in lane order. So every pixel's sum is taken in (instance, sample) order,
// as the sequential scatter-add takes it. The band goes out as 16-byte
// stores; a band without records stores zeros without touching shared
// memory.
__global__ void __launch_bounds__(kThreads)
nmap_band_kernel(const int4* __restrict__ recs, const int* __restrict__ ends,
                 int MP, int H, int W, int nbands, int nchunks,
                 float* __restrict__ out0, float* __restrict__ out1) {   // [B, H, W]
  extern __shared__ float4 s_mem[];
  float* plane0 = reinterpret_cast<float*>(s_mem);             // [kBandRows * W]
  float* plane1 = plane0 + kBandRows * W;
  int* list_pix = reinterpret_cast<int*>(plane1 + kBandRows * W);   // [kListCap]
  float* list_n0 = reinterpret_cast<float*>(list_pix + kListCap);
  float* list_n1 = list_n0 + kListCap;
  int* pos = reinterpret_cast<int*>(list_n1 + kListCap);        // [nchunks]
  int* from = pos + nchunks;                                    // [nchunks]
  __shared__ int s_warp[kWarps];
  const int b = blockIdx.y, band = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rows = min(kBandRows, H - band * kBandRows);

  // each chunk's count in this band and where its records start
  const int per = (nchunks + kThreads - 1) / kThreads;
  int sum = 0;
  for (int k = 0; k < per; ++k) {
    const int c = tid * per + k;
    if (c < nchunks) {
      const int* e = ends + ((size_t)b * nchunks + c) * nbands + band;
      const int start = band > 0 ? e[-1] : 0;
      from[c] = start;
      pos[c] = e[0] - start;
      sum += e[0] - start;
    }
  }
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int run = incl - sum, total = 0;
  for (int v = 0; v < kWarps; ++v) {
    if (v < warp) run += s_warp[v];
    total += s_warp[v];
  }
  for (int k = 0; k < per; ++k) {
    const int c = tid * per + k;
    if (c < nchunks) {
      const int count = pos[c];
      pos[c] = run;
      run += count;
    }
  }

  const size_t obase = ((size_t)b * H + band * kBandRows) * W;
  const int n4 = rows * W / 4;                    // W % 4 == 0
  float4* o0 = reinterpret_cast<float4*>(out0 + obase);
  float4* o1 = reinterpret_cast<float4*>(out1 + obase);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (total == 0) {                               // uniform across the block
    for (int i = tid; i < n4; i += kThreads) {
      o0[i] = zero;
      o1[i] = zero;
    }
    return;
  }
  float4* p0 = reinterpret_cast<float4*>(plane0);
  float4* p1 = reinterpret_cast<float4*>(plane1);
  for (int i = tid; i < n4; i += kThreads) {
    p0[i] = zero;
    p1[i] = zero;
  }
  const int4* img = recs + (size_t)b * MP;
  for (int w0 = 0; w0 < total; w0 += kListCap) {
    const int count = min(kListCap, total - w0);
    __syncthreads();                              // pos/from, zeros, the last window
    for (int i = tid; i < count; i += kThreads) {
      const int g = w0 + i;
      int lo = 0, hi = nchunks - 1;               // the last chunk starting at or before g
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (pos[mid] <= g) lo = mid; else hi = mid - 1;
      }
      const int4 r = img[(size_t)lo * kChunk + from[lo] + (g - pos[lo])];
      list_pix[i] = r.x;
      list_n0[i] = __int_as_float(r.y);
      list_n1[i] = __int_as_float(r.z);
    }
    __syncthreads();
    for (int s0 = 0; s0 < count; s0 += 32) {
      const int i = s0 + lane;
      const int px = i < count ? list_pix[i] : -1;
      const bool mine = px >= 0 && ((px >> 2) % kWarps) == warp;
      const unsigned grp = __match_any_sync(kFull, mine ? px : -1);
      if (mine && lane == __ffs(grp) - 1) {
        float a0 = plane0[px], a1 = plane1[px];
        for (unsigned m = grp; m; m &= m - 1) {
          const int k = s0 + __ffs(m) - 1;
          a0 += list_n0[k];
          a1 += list_n1[k];
        }
        plane0[px] = a0;
        plane1[px] = a1;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n4; i += kThreads) {
    o0[i] = p0[i];
    o1[i] = p1[i];
  }
}

size_t nmap_band_smem(int W, int nchunks) {
  return sizeof(float) * 2 * kBandRows * W + (sizeof(int) + 2 * sizeof(float)) * kListCap +
         sizeof(int) * 2 * nchunks;
}

// Raises a kernel's dynamic shared-memory limit to `bytes` once per process
// and device (`done` holds what was set so far, per device).
cudaError_t allow_smem(const void* kernel, size_t bytes, size_t* done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (bytes <= done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done[dev] = bytes;
  return err;
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int iseg_rasterize_cnt_r2(const void* ys, const void* xs, const void* has,
                                     int B, int M, int P, int H, int W, void* cnt,
                                     void* r2, void* uni, void* stream) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  cnt_r2_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ys, (const int32_t*)xs, (const uint8_t*)has, M, P, H, W,
      (uint16_t*)cnt, (uint8_t*)r2, (uint8_t*)uni);
  return (int)cudaGetLastError();
}

// BM = B * M slabs, and BM times a slab's items (bands and 16 KB fills)
// below 2^31 (the wrapper checks). A persistent grid: as many blocks as the
// card's SMs hold at once, or the items if fewer.
extern "C" int iseg_minr2_from_cnt(const void* cnt, const void* has, int BM, int H, int W,
                                   void* r2, void* stream) {
  static int resident[64][2];                    // per device: blocks per SM x SMs
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  // counts as 16-byte vectors where they align so, else as 8-byte ones
  const bool wide = W % 8 == 0 && (uintptr_t)cnt % 16 == 0;
  const void* kernel = wide ? (const void*)minr2_kernel<8> : (const void*)minr2_kernel<4>;
  int& blocks = resident[dev][wide];
  if (blocks == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    blocks = per_sm * sms;
  }
  const long long items = (long long)BM * std::max<long long>(
      (long long)((H + kBandH - 1) / kBandH) * ((W + kBandW - 1) / kBandW),
      ((long long)H * W + kFillBytes - 1) / kFillBytes);
  const int grid = (int)std::min<long long>(blocks, items);
  if (wide)
    minr2_kernel<8><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)cnt, (const uint8_t*)has, BM, H, W, (uint8_t*)r2);
  else
    minr2_kernel<4><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)cnt, (const uint8_t*)has, BM, H, W, (uint8_t*)r2);
  return (int)cudaGetLastError();
}

// Scratch of K5: the records (16 B per point) and the bands' ends per chunk.
extern "C" size_t iseg_nmap_scratch_bytes(int B, int M, int P, int H) {
  const int nbands = (H + kBandRows - 1) / kBandRows;
  const int nchunks = (M * P + kChunk - 1) / kChunk;
  return (size_t)B * M * P * sizeof(int4) + (size_t)B * nchunks * nbands * sizeof(int);
}

// points [B, M, P, 2] int32, valid [B, M, P] bool (its bytes), normals
// [B, M, P, 2] f32 -> out [2, B, H, W] f32; two launches.
extern "C" int iseg_rasterize_nmap(const void* points, const void* valid, const void* normals,
                                   int B, int M, int P, int H, int W, void* out, void* scratch,
                                   void* stream) {
  static size_t bin_done[64], band_done[64];
  const int MP = M * P;
  const int nbands = (H + kBandRows - 1) / kBandRows;
  const int nchunks = (MP + kChunk - 1) / kChunk;
  int4* recs = (int4*)scratch;
  int* ends = (int*)(recs + (size_t)B * MP);
  const size_t bin_smem = sizeof(int) * kWarps * nbands;
  const size_t band_smem = nmap_band_smem(W, nchunks);
  cudaError_t err = allow_smem((const void*)nmap_bin_kernel, bin_smem, bin_done);
  if (err == cudaSuccess)
    err = allow_smem((const void*)nmap_band_kernel, band_smem, band_done);
  if (err != cudaSuccess) return (int)err;
  nmap_bin_kernel<<<dim3((nchunks + kWarps - 1) / kWarps, B), kThreads, bin_smem,
                    (cudaStream_t)stream>>>(
      (const int2*)points, (const uint8_t*)valid, (const float2*)normals, MP, H, W, nbands,
      nchunks, recs, ends);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* out0 = (float*)out;
  nmap_band_kernel<<<dim3(nbands, B), kThreads, band_smem, (cudaStream_t)stream>>>(
      recs, ends, MP, H, W, nbands, nchunks, out0, out0 + (size_t)B * H * W);
  return (int)cudaGetLastError();
}
