// Kernels K3 and K4: the AE (spatial-embedding) loss terms, forward and
// backward.
//
// K3 replaces instance_segmentation_tpu/losses/ae_pallas.py ae_terms forward
// (_fwd_impl, _make_fwd_kernel); K4 replaces its custom VJP (_bwd_impl,
// _make_bwd_kernel). Per image b, instance m and pixel p, with
//
//     d(p, m)  = exp(-((ey - cy_m)^2 * sy + (ex - cx_m)^2 * sx))
//     pred     = clip(d, 1e-4, 1 - 1e-4)
//     win(p,m) = lt_m <= p < rb_m (rows and columns) and m valid
//     dmax(p)  = max over valid m of d(p, m)   (0 where no sample can need it)
//
// K3 sums, over the pixels, pos = [cnt > 0 and win] log(pred)(1 - pred)^2,
// neg = win log(1 - pred) pred^2 (1 - g)^4 (the weight looked up from the u8
// min-r2 map), npos = [cnt > 0 and win], pull = cnt |d - dmax|. K4 takes the
// cotangents of pos, neg and pull (npos is a count: none) and writes
// d/d(ey, ex, sy, sx), routing each pixel's dmax cotangent to its first-max
// center (strict '>' in index order), as the TPU kernel does.
//
// What bounds them on the card: bytes. Each reads the four f32 fields once
// (16 B per pixel, 67 MB at B=8, 512x1024) and, for each (tile, instance)
// pair it cannot skip, 3 B per pixel of the cnt/r2 slabs; K4 writes 16 B per
// pixel. A block owns a 16 x 64 tile (4 adjacent pixels a thread, vector
// loads). An instance is visited in a tile only where its window overlaps
// the tile or it has samples there (the presence table from the point list),
// the TPU kernel's skip rule, so the ~805 MB count map is read only where it
// matters; dmax is computed only in tiles holding samples. K3 writes one
// partial per (tile, instance) and a second kernel sums the tiles in a fixed
// order: no float atomics, the result is deterministic.
//
// The affinity is computed with __fmul_rn/__fadd_rn everywhere it appears so
// that the forward, dmax and the backward see the same bits; expf/logf are
// the full-precision functions (no --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 16;
constexpr int kTileW = 64;                       // 16 threads x 4 columns
constexpr int kMaxM = 128;
constexpr float kEps = 1e-4f;
enum { kCY, kCX, kLT0, kLT1, kRB0, kRB1, kValid };   // fields of a table row
constexpr int kTabW = 8;                         // floats per table row (one unused)

__device__ __forceinline__ float affinity(float ey, float ex, float sy, float sx,
                                          float cy, float cx) {
  const float dy = __fsub_rn(ey, cy), dx = __fsub_rn(ex, cx);
  const float expo = __fadd_rn(__fmul_rn(__fmul_rn(dy, dy), sy),
                               __fmul_rn(__fmul_rn(dx, dx), sx));
  return expf(-expo);
}

// Shared set-up of both kernels: the image's instance table, the (1-g)^4
// table, and which instances this tile visits.
struct Tile {
  int b, tile, ntiles, r0, c0, row, col;
  bool ok;
};

__device__ Tile tile_setup(const float* __restrict__ tab, const float* __restrict__ lut,
                           const uint8_t* __restrict__ cntp, int M, int H, int W,
                           float (*s_tab)[kMaxM], float* s_lut, uint8_t* s_hit,
                           int* s_any) {
  Tile t;
  t.b = blockIdx.z;
  t.ntiles = gridDim.x * gridDim.y;
  t.tile = blockIdx.y * gridDim.x + blockIdx.x;
  t.r0 = blockIdx.y * kTileH;
  t.c0 = blockIdx.x * kTileW;
  t.row = t.r0 + threadIdx.x / (kTileW / 4);
  t.col = t.c0 + (threadIdx.x % (kTileW / 4)) * 4;
  t.ok = t.row < H && t.col < W;                 // W % 4 == 0
  if (threadIdx.x == 0) *s_any = 0;
  for (int i = threadIdx.x; i < 256; i += kThreads) s_lut[i] = lut[i];
  for (int i = threadIdx.x; i < M * kTabW; i += kThreads)
    s_tab[i % kTabW][i / kTabW] = tab[(size_t)t.b * M * kTabW + i];
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const bool pts = cntp[((size_t)t.b * M + m) * t.ntiles + t.tile] != 0;
    const bool win = s_tab[kValid][m] > 0.0f && s_tab[kLT0][m] < (float)(t.r0 + kTileH) &&
                     s_tab[kRB0][m] > (float)t.r0 && s_tab[kLT1][m] < (float)(t.c0 + kTileW) &&
                     s_tab[kRB1][m] > (float)t.c0;
    s_hit[m] = pts || win;
    if (pts) *s_any = 1;
  }
  __syncthreads();
  return t;
}

__device__ __forceinline__ void load4(const float* __restrict__ p, size_t o, bool ok,
                                      float* v) {
  const float4 q = ok ? *reinterpret_cast<const float4*>(p + o) : make_float4(0, 0, 0, 0);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load_slab4(const uint8_t* __restrict__ r2,
                                           const uint16_t* __restrict__ cnt, size_t o,
                                           int* rv, float* cv) {
  const uint32_t rw = *reinterpret_cast<const uint32_t*>(r2 + o);
  const uint2 cw = *reinterpret_cast<const uint2*>(cnt + o);
  rv[0] = rw & 0xFF; rv[1] = (rw >> 8) & 0xFF; rv[2] = (rw >> 16) & 0xFF; rv[3] = rw >> 24;
  cv[0] = (float)(cw.x & 0xFFFF); cv[1] = (float)(cw.x >> 16);
  cv[2] = (float)(cw.y & 0xFFFF); cv[3] = (float)(cw.y >> 16);
}

__device__ __forceinline__ bool in_window(const float (*s_tab)[kMaxM], int m, float r,
                                          float c) {
  return s_tab[kValid][m] > 0.0f && r >= s_tab[kLT0][m] && r < s_tab[kRB0][m] &&
         c >= s_tab[kLT1][m] && c < s_tab[kRB1][m];
}

__global__ void __launch_bounds__(kThreads)
ae_fwd_kernel(const float* __restrict__ ey, const float* __restrict__ ex,
              const float* __restrict__ sy, const float* __restrict__ sx,   // [B, H, W]
              const uint8_t* __restrict__ r2, const uint16_t* __restrict__ cnt,  // [B, M, H, W]
              const float* __restrict__ tab,     // [B, M, 8]
              const float* __restrict__ lut,     // [256]
              const uint8_t* __restrict__ cntp,  // [B, M, ntiles]
              int M, int H, int W,
              float* __restrict__ partial) {     // [B, ntiles, M, 4]
  __shared__ float s_tab[kTabW][kMaxM];
  __shared__ float s_lut[256];
  __shared__ uint8_t s_hit[kMaxM];
  __shared__ int s_any;
  __shared__ float s_red[kThreads / 32][4];
  const Tile t = tile_setup(tab, lut, cntp, M, H, W, s_tab, s_lut, s_hit, &s_any);
  float* out = partial + ((size_t)t.b * t.ntiles + t.tile) * M * 4;
  for (int i = threadIdx.x; i < M * 4; i += kThreads)
    if (!s_hit[i / 4]) out[i] = 0.0f;

  const size_t pix = ((size_t)t.b * H + t.row) * W + t.col;
  float vey[4], vex[4], vsy[4], vsx[4];
  load4(ey, pix, t.ok, vey); load4(ex, pix, t.ok, vex);
  load4(sy, pix, t.ok, vsy); load4(sx, pix, t.ok, vsx);

  float dmax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (s_any && t.ok) {
    for (int m = 0; m < M; ++m) {
      if (!(s_tab[kValid][m] > 0.0f)) continue;
      for (int j = 0; j < 4; ++j)
        dmax[j] = fmaxf(dmax[j], affinity(vey[j], vex[j], vsy[j], vsx[j],
                                          s_tab[kCY][m], s_tab[kCX][m]));
    }
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int m = 0; m < M; ++m) {
    if (!s_hit[m]) continue;                     // uniform across the block
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};     // pos, neg, npos, pull
    if (t.ok) {
      int rv[4];
      float cv[4];
      load_slab4(r2, cnt, ((size_t)t.b * M + m) * H * W + (size_t)t.row * W + t.col, rv, cv);
      for (int j = 0; j < 4; ++j) {
        const float d = affinity(vey[j], vex[j], vsy[j], vsx[j], s_tab[kCY][m], s_tab[kCX][m]);
        const float pred = fminf(fmaxf(d, kEps), 1.0f - kEps);
        const bool win = in_window(s_tab, m, (float)t.row, (float)(t.col + j));
        if (win) {
          acc[1] += logf(1.0f - pred) * pred * pred * s_lut[rv[j]];
          if (cv[j] > 0.0f) {
            acc[0] += logf(pred) * (1.0f - pred) * (1.0f - pred);
            acc[2] += 1.0f;
          }
        }
        acc[3] += cv[j] * fabsf(d - dmax[j]);
      }
    }
    for (int k = 0; k < 4; ++k)
      for (int s = 16; s > 0; s >>= 1) acc[k] += __shfl_down_sync(0xffffffffu, acc[k], s);
    if (lane == 0)
      for (int k = 0; k < 4; ++k) s_red[warp][k] = acc[k];
    __syncthreads();
    if (threadIdx.x < 4) {
      float s = 0.0f;
      for (int v = 0; v < kThreads / 32; ++v) s += s_red[v][threadIdx.x];
      out[m * 4 + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

__global__ void ae_reduce_kernel(const float* __restrict__ partial,  // [B, ntiles, M, 4]
                                 int B, int ntiles, int M,
                                 float* __restrict__ out) {          // [4, B, M]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * M * 4) return;
  const int k = i % 4, m = (i / 4) % M, b = i / (4 * M);
  float s = 0.0f;
  for (int tl = 0; tl < ntiles; ++tl) s += partial[(((size_t)b * ntiles + tl) * M + m) * 4 + k];
  out[((size_t)k * B + b) * M + m] = s;
}

__global__ void __launch_bounds__(kThreads)
ae_bwd_kernel(const float* __restrict__ ey, const float* __restrict__ ex,
              const float* __restrict__ sy, const float* __restrict__ sx,
              const uint8_t* __restrict__ r2, const uint16_t* __restrict__ cnt,
              const float* __restrict__ tab, const float* __restrict__ lut,
              const uint8_t* __restrict__ cntp,
              const float* __restrict__ g,       // [B, M, 4]: d pos, d neg, -, d pull
              int M, int H, int W,
              float* __restrict__ dey, float* __restrict__ dex,
              float* __restrict__ dsy, float* __restrict__ dsx) {   // [B, H, W]
  __shared__ float s_tab[kTabW][kMaxM];
  __shared__ float s_lut[256];
  __shared__ uint8_t s_hit[kMaxM];
  __shared__ int s_any;
  __shared__ float s_g[3][kMaxM];
  const Tile t = tile_setup(tab, lut, cntp, M, H, W, s_tab, s_lut, s_hit, &s_any);
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const float* gm = g + ((size_t)t.b * M + m) * 4;
    s_g[0][m] = gm[0];
    s_g[1][m] = gm[1];
    s_g[2][m] = gm[3];
  }
  __syncthreads();
  if (!t.ok) return;                             // no block-wide sync follows

  const size_t pix = ((size_t)t.b * H + t.row) * W + t.col;
  float vey[4], vex[4], vsy[4], vsx[4];
  load4(ey, pix, true, vey); load4(ex, pix, true, vex);
  load4(sy, pix, true, vsy); load4(sx, pix, true, vsx);

  // pass A: dmax and its first-max center
  float dmax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int amax[4] = {-1, -1, -1, -1};
  if (s_any) {
    for (int m = 0; m < M; ++m) {
      if (!(s_tab[kValid][m] > 0.0f)) continue;
      for (int j = 0; j < 4; ++j) {
        const float d = affinity(vey[j], vex[j], vsy[j], vsx[j], s_tab[kCY][m], s_tab[kCX][m]);
        if (d > dmax[j]) { dmax[j] = d; amax[j] = m; }
      }
    }
  }

  // pass B: focal backward (clip mask) and the pull own-term; the pull's
  // dmax cotangent accumulates in gmax
  float aey[4] = {0, 0, 0, 0}, aex[4] = {0, 0, 0, 0}, asy[4] = {0, 0, 0, 0},
        asx[4] = {0, 0, 0, 0}, gmax[4] = {0, 0, 0, 0};
  for (int m = 0; m < M; ++m) {
    if (!s_hit[m]) continue;
    int rv[4];
    float cv[4];
    load_slab4(r2, cnt, ((size_t)t.b * M + m) * H * W + (size_t)t.row * W + t.col, rv, cv);
    const float cy = s_tab[kCY][m], cx = s_tab[kCX][m];
    for (int j = 0; j < 4; ++j) {
      const float tv = affinity(vey[j], vex[j], vsy[j], vsx[j], cy, cx);
      const float tc = fminf(fmaxf(tv, kEps), 1.0f - kEps);
      const float pass_g = (tv >= kEps && tv <= 1.0f - kEps) ? 1.0f : 0.0f;
      const bool win = in_window(s_tab, m, (float)t.row, (float)(t.col + j));
      const float wf = win ? 1.0f : 0.0f;
      const float posm = (win && cv[j] > 0.0f) ? 1.0f : 0.0f;
      const float dneg_dt = s_lut[rv[j]] * wf *
                            (2.0f * tc * logf(1.0f - tc) - tc * tc / (1.0f - tc));
      const float dpos_dt = posm * ((1.0f - tc) * (1.0f - tc) / tc -
                                    2.0f * (1.0f - tc) * logf(tc));
      float gt = (s_g[1][m] * dneg_dt + s_g[0][m] * dpos_dt) * pass_g;
      const float diff = tv - dmax[j];
      const float sgn = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f);
      const float gpull_own = s_g[2][m] * cv[j] * sgn;
      gt += gpull_own;
      gmax[j] -= gpull_own;
      const float gexpo = gt * (-tv);
      const float dy = __fsub_rn(vey[j], cy), dx = __fsub_rn(vex[j], cx);
      aey[j] += gexpo * 2.0f * dy * vsy[j];
      aex[j] += gexpo * 2.0f * dx * vsx[j];
      asy[j] += gexpo * dy * dy;
      asx[j] += gexpo * dx * dx;
    }
  }

  // pass C: the dmax cotangent goes to each pixel's argmax center
  for (int j = 0; j < 4; ++j) {
    if (amax[j] < 0) continue;
    const float cy = s_tab[kCY][amax[j]], cx = s_tab[kCX][amax[j]];
    const float d = affinity(vey[j], vex[j], vsy[j], vsx[j], cy, cx);
    const float gexpo = gmax[j] * (-d);
    const float dy = __fsub_rn(vey[j], cy), dx = __fsub_rn(vex[j], cx);
    aey[j] += gexpo * 2.0f * dy * vsy[j];
    aex[j] += gexpo * 2.0f * dx * vsx[j];
    asy[j] += gexpo * dy * dy;
    asx[j] += gexpo * dx * dx;
  }
  *reinterpret_cast<float4*>(dey + pix) = make_float4(aey[0], aey[1], aey[2], aey[3]);
  *reinterpret_cast<float4*>(dex + pix) = make_float4(aex[0], aex[1], aex[2], aex[3]);
  *reinterpret_cast<float4*>(dsy + pix) = make_float4(asy[0], asy[1], asy[2], asy[3]);
  *reinterpret_cast<float4*>(dsx + pix) = make_float4(asx[0], asx[1], asx[2], asx[3]);
}

dim3 tile_grid(int B, int H, int W) {
  return dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// `partial` is scratch of B * ntiles * M * 4 floats, ntiles as iseg_ae_tiles.
extern "C" int iseg_ae_tiles(int H, int W) {
  const dim3 g = tile_grid(1, H, W);
  return (int)(g.x * g.y);
}

extern "C" int iseg_ae_terms_fwd(const void* ey, const void* ex, const void* sy,
                                 const void* sx, const void* r2, const void* cnt,
                                 const void* tab, const void* lut, const void* cntp,
                                 int B, int M, int H, int W, void* partial, void* out,
                                 void* stream) {
  const dim3 grid = tile_grid(B, H, W);
  ae_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ey, (const float*)ex, (const float*)sy, (const float*)sx,
      (const uint8_t*)r2, (const uint16_t*)cnt, (const float*)tab, (const float*)lut,
      (const uint8_t*)cntp, M, H, W, (float*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = B * M * 4;
  ae_reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)partial, B, (int)(grid.x * grid.y), M, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int iseg_ae_terms_bwd(const void* ey, const void* ex, const void* sy,
                                 const void* sx, const void* r2, const void* cnt,
                                 const void* tab, const void* lut, const void* cntp,
                                 const void* g, int B, int M, int H, int W, void* dey,
                                 void* dex, void* dsy, void* dsx, void* stream) {
  ae_bwd_kernel<<<tile_grid(B, H, W), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ey, (const float*)ex, (const float*)sy, (const float*)sx,
      (const uint8_t*)r2, (const uint16_t*)cnt, (const float*)tab, (const float*)lut,
      (const uint8_t*)cntp, (const float*)g, M, H, W, (float*)dey, (float*)dex,
      (float*)dsy, (float*)dsx);
  return (int)cudaGetLastError();
}
