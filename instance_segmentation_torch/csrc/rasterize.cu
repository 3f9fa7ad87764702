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
// image, the sum of the valid samples' inward normals at their pixels, the
// tangent loss's target field (two f32 planes).
//
// K6 replaces instance_segmentation_tpu/losses/minr2_pallas.py
// minr2_from_cnt (_make_kernel, _axis_min): the same u8 min-r2 map, read
// from an existing u16 count map (the route taken where K2's rule refuses
// the shape, e.g. 1024x2048), with slabs whose instance has no valid sample
// set to 200 whatever their counts hold. Bit-exact. K2 and K6 share the
// separable min (column_min_pass, row_min).
//
// Points arrive pre-clipped: valid samples lie inside the image, invalid
// ones are encoded out of range (y = H, x = W) and are never counted.
//
// What bounds them on the card:
//  * K2 writes B*M*H*W*3 bytes plus the union (1.2 GB at B=8, M=96,
//    512x1024): bytes. Most slots are padding (no valid point): those
//    blocks only store the constants cnt 0 / r2 200, as 16- and 8-byte
//    vector stores. A live slot's tile (16 x 128 pixels plus a 3-pixel halo)
//    counts its points in shared memory with shared atomics (integer, so
//    exact in any order), then runs the separable column/row min there; the
//    union stays in registers across the instance loop.
//  * K5 reads the point list and writes 2*B*H*W floats (~34 MB): bytes and
//    launch latency. A block owns a band of rows of one image and keeps the
//    band's two planes in shared memory. It walks only the instances whose
//    sample rows reach the band; their points in the band are gathered in
//    (instance, point) order into a shared list, and each thread owns a
//    fixed set of columns and adds the listed normals that land there, in
//    list order. No float atomics: the sums are deterministic, and each
//    pixel's sum is taken in the order a sequential scatter-add takes it.
//  * K6 reads the live slabs' counts (2 B/px) and writes r2 (1 B/px) for
//    every slab: bytes. One block per (16 x 128 tile, image * instance). A
//    slab whose instance has no valid sample (most slots are padding) reads
//    no count: it stores 200 with 4-byte stores. A live tile loads its halo
//    of cnt != 0 flags (out-of-image pixels empty) into shared memory and
//    runs K2's two passes.

#include <cuda_runtime.h>
#include <stdint.h>

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
__global__ void __launch_bounds__(kThreads)
minr2_kernel(const uint16_t* __restrict__ cnt,   // [B * M, H, W]
             const uint8_t* __restrict__ has,    // [B * M]
             int H, int W,
             uint8_t* __restrict__ r2) {         // [B * M, H, W]
  __shared__ int flags[kHaloH][kHaloW];
  __shared__ uint8_t colmin[kHaloH][kTileW];
  const size_t bm = blockIdx.z;
  const size_t slab = bm * H * W;
  const int r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x;
  const int lc = (tid % (kTileW / 4)) * 4;
  const int lr = tid / (kTileW / 4);
  const bool col_ok = c0 + lc < W;               // W % 4 == 0: all 4 or none
  if (!has[bm]) {                                // uniform across the block
    for (int k = 0; k < kPasses; ++k) {
      const int row = r0 + lr + k * kRowsPerPass;
      if (row < H && col_ok)
        *reinterpret_cast<uint32_t*>(r2 + slab + (size_t)row * W + c0 + lc) = 0xC8C8C8C8u;
    }
    return;
  }
  for (int i = tid; i < kHaloH * kHaloW; i += kThreads) {
    const int rr = i / kHaloW, cc = i % kHaloW;
    const int row = r0 - kRadius + rr, col = c0 - kRadius + cc;
    (&flags[0][0])[i] = (row >= 0 && row < H && col >= 0 && col < W)
                            ? (cnt[slab + (size_t)row * W + col] != 0)
                            : 0;
  }
  __syncthreads();
  column_min_pass(flags, colmin, tid);
  __syncthreads();
  for (int k = 0; k < kPasses; ++k) {
    const int tr = lr + k * kRowsPerPass;
    const int row = r0 + tr;
    uint8_t rv[4];
    for (int j = 0; j < 4; ++j) rv[j] = row_min(colmin, tr, lc + j);
    if (row < H && col_ok)
      *reinterpret_cast<uint32_t*>(r2 + slab + (size_t)row * W + c0 + lc) = pack4(rv);
  }
}

// ---- K5 ---------------------------------------------------------------------
constexpr int kBandRows = 4;                     // rows of one image per block

__global__ void __launch_bounds__(kThreads)
nmap_kernel(const int32_t* __restrict__ ys,      // [B, M, P]
            const int32_t* __restrict__ xs,      // [B, M, P]
            const float* __restrict__ n0,        // [B, M, P]
            const float* __restrict__ n1,        // [B, M, P]
            const int32_t* __restrict__ rows,    // [B, M, 2]: first, last sample row
            int M, int P, int H, int W,
            float* __restrict__ out0,            // [B, H, W]
            float* __restrict__ out1) {          // [B, H, W]
  extern __shared__ float band[];                // [2][kBandRows][W]
  __shared__ int list_pix[kThreads];             // row * W + col within the band
  __shared__ float list_n0[kThreads], list_n1[kThreads];
  __shared__ int warp_count[kThreads / 32];
  const int b = blockIdx.y, r0 = blockIdx.x * kBandRows;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rows_here = min(kBandRows, H - r0);
  // each thread owns the band pixels whose column is tid mod kThreads
  for (int r = 0; r < rows_here; ++r)
    for (int c = tid; c < W; c += kThreads) {
      band[r * W + c] = 0.0f;
      band[(kBandRows + r) * W + c] = 0.0f;
    }
  for (int m = 0; m < M; ++m) {
    const int2 span = reinterpret_cast<const int2*>(rows)[(size_t)b * M + m];
    if (span.y < r0 || span.x >= r0 + rows_here) continue;   // uniform across the block
    const size_t pbase = ((size_t)b * M + m) * P;
    for (int p0 = 0; p0 < P; p0 += kThreads) {
      const int p = p0 + tid;
      int py = H, px = W;
      if (p < P) {
        py = ys[pbase + p];
        px = xs[pbase + p];
      }
      const bool in = py >= r0 && py < r0 + rows_here && px < W;
      const unsigned ballot = __ballot_sync(0xffffffffu, in);
      if (lane == 0) warp_count[warp] = __popc(ballot);
      __syncthreads();
      int base = 0, total = 0;
      for (int v = 0; v < kThreads / 32; ++v) {
        if (v < warp) base += warp_count[v];
        total += warp_count[v];
      }
      if (in) {
        const int slot = base + __popc(ballot & ((1u << lane) - 1u));
        list_pix[slot] = (py - r0) * W + px;
        list_n0[slot] = n0[pbase + p];
        list_n1[slot] = n1[pbase + p];
      }
      __syncthreads();
      for (int e = 0; e < total; ++e) {
        const int pix = list_pix[e];
        if (pix % W % kThreads == tid) {
          band[pix] += list_n0[e];
          band[kBandRows * W + pix] += list_n1[e];
        }
      }
      __syncthreads();                           // before the list is rebuilt
    }
  }
  for (int r = 0; r < rows_here; ++r)
    for (int c = tid; c < W; c += kThreads) {
      const size_t o = ((size_t)b * H + r0 + r) * W + c;
      out0[o] = band[r * W + c];
      out1[o] = band[(kBandRows + r) * W + c];
    }
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

// BM = B * M slabs; gridDim.z caps it at 65535 (the wrapper checks).
extern "C" int iseg_minr2_from_cnt(const void* cnt, const void* has, int BM, int H, int W,
                                   void* r2, void* stream) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, BM);
  minr2_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)cnt, (const uint8_t*)has, H, W, (uint8_t*)r2);
  return (int)cudaGetLastError();
}

extern "C" int iseg_rasterize_nmap(const void* ys, const void* xs, const void* n0,
                                   const void* n1, const void* rows, int B, int M, int P,
                                   int H, int W, void* out0, void* out1, void* stream) {
  const size_t smem = sizeof(float) * 2 * kBandRows * W;
  cudaError_t err = cudaFuncSetAttribute(
      nmap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kBandRows - 1) / kBandRows, B);
  nmap_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)ys, (const int32_t*)xs, (const float*)n0, (const float*)n1,
      (const int32_t*)rows, M, P, H, W, (float*)out0, (float*)out1);
  return (int)cudaGetLastError();
}
