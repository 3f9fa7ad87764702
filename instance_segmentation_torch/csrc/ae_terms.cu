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
// pixel. Work goes by 16 x 64 tiles (4 adjacent pixels a thread, vector
// loads). An instance is visited in a tile only where its window overlaps
// the tile or it has samples there (the presence bitmask from the point
// list, [B, ntiles, 4] words, bit m for instance m), the TPU kernel's skip
// rule, so the ~805 MB count map is read only where it matters; dmax is
// computed only in tiles holding samples. K3 gives a block one tile and
// writes one partial per (tile, instance); a second kernel sums the tiles in
// a fixed order: no float atomics, the result is deterministic.
//
// K4's blocks are smaller (128 threads, half a tile, 80 registers so six
// blocks fit an SM): it is bound by the latency of its dependent loads more
// than by its arithmetic. A block stages its image's valid instances once,
// compacted in index order (center, window, the three cotangents), so its
// passes run over the valid instances only; it reads the tile's presence in
// one 16-byte load. The focal pass comes first and needs no dmax: it loads
// the next visited instance's slab before this one's arithmetic, shares one
// IEEE reciprocal between the two divisions of the focal derivatives and marks
// the pixels holding samples. dmax, its first-max center and the pull term
// are computed at those pixels only, the only ones where the pull has a
// gradient. Every pixel's gradient is written by one thread, no atomics.
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
constexpr int kBwdThreads = 128;                 // K4's block
constexpr int kBwdMinBlocks = 6;                 // K4: blocks an SM should hold
static_assert(kMaxM == 4 * 32, "a tile's presence is one uint4 (4 words of 32 instances)");
static_assert(kBwdThreads >= kMaxM, "K4 stages the table one entry a thread");

__device__ __forceinline__ float affinity(float ey, float ex, float sy, float sx,
                                          float cy, float cx) {
  const float dy = __fsub_rn(ey, cy), dx = __fsub_rn(ex, cx);
  const float expo = __fadd_rn(__fmul_rn(__fmul_rn(dy, dy), sy),
                               __fmul_rn(__fmul_rn(dx, dx), sx));
  return expf(-expo);
}

// Whether instance m has samples in the tile whose presence words are w.
__device__ __forceinline__ bool present(const uint4& w, int m) {
  const unsigned word = m < 64 ? (m < 32 ? w.x : w.y) : (m < 96 ? w.z : w.w);
  return (word >> (m % 32)) & 1u;
}

// K3's set-up, a block per tile: the image's instance table, the (1-g)^4
// table, and which instances this tile visits.
struct Tile {
  int b, tile, ntiles, r0, c0, row, col;
  bool ok;
};

__device__ Tile tile_setup(const float* __restrict__ tab, const float* __restrict__ lut,
                           const uint4* __restrict__ cntp, int M, int H, int W,
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
  const uint4 words = cntp[(size_t)t.b * t.ntiles + t.tile];
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const bool pts = present(words, m);
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

__device__ __forceinline__ void store4(float* __restrict__ p, size_t o, const float* v) {
  *reinterpret_cast<float4*>(p + o) = make_float4(v[0], v[1], v[2], v[3]);
}

// The slab words at 4 adjacent pixels: (r2 bytes, cnt halves 0-1, 2-3).
__device__ __forceinline__ uint3 load_slab(const uint8_t* __restrict__ r2,
                                           const uint16_t* __restrict__ cnt, size_t o) {
  const uint2 c = *reinterpret_cast<const uint2*>(cnt + o);
  return make_uint3(*reinterpret_cast<const uint32_t*>(r2 + o), c.x, c.y);
}

__device__ __forceinline__ float count_of(const uint3& slab, int j) {
  return (float)(((j < 2 ? slab.y : slab.z) >> (16 * (j % 2))) & 0xFFFFu);
}

__device__ __forceinline__ int r2_of(const uint3& slab, int j) {
  return (slab.x >> (8 * j)) & 0xFFu;
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
              const uint4* __restrict__ cntp,    // [B, ntiles]: presence bits
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
      const uint3 slab =
          load_slab(r2, cnt, ((size_t)t.b * M + m) * H * W + (size_t)t.row * W + t.col);
      for (int j = 0; j < 4; ++j) {
        const float cv = count_of(slab, j);
        const float d = affinity(vey[j], vex[j], vsy[j], vsx[j], s_tab[kCY][m], s_tab[kCX][m]);
        const float pred = fminf(fmaxf(d, kEps), 1.0f - kEps);
        const bool win = in_window(s_tab, m, (float)t.row, (float)(t.col + j));
        if (win) {
          acc[1] += logf(1.0f - pred) * pred * pred * s_lut[r2_of(slab, j)];
          if (cv > 0.0f) {
            acc[0] += logf(pred) * (1.0f - pred) * (1.0f - pred);
            acc[2] += 1.0f;
          }
        }
        acc[3] += cv * fabsf(d - dmax[j]);
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

// A block of kBwdThreads threads covers kBwdThreads * 4 / kTileW rows of one
// 16 x 64 presence tile, 4 adjacent pixels a thread.
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
ae_bwd_kernel(const float* __restrict__ ey, const float* __restrict__ ex,
              const float* __restrict__ sy, const float* __restrict__ sx,   // [B, H, W]
              const uint8_t* __restrict__ r2, const uint16_t* __restrict__ cnt,  // [B, M, H, W]
              const float* __restrict__ tab, const float* __restrict__ lut,
              const uint4* __restrict__ cntp,    // [B, ntiles]: presence bits
              const float* __restrict__ g_pos, const float* __restrict__ g_neg,
              const float* __restrict__ g_pull,  // [B, M] cotangents
              int M, int H, int W,
              float* __restrict__ dey, float* __restrict__ dex,
              float* __restrict__ dsy, float* __restrict__ dsx) {   // [B, H, W]
  constexpr int kRows = kBwdThreads * 4 / kTileW;
  constexpr int kParts = kTileH / kRows;         // blocks per presence tile
  static_assert(kTileH % kRows == 0, "a block's rows lie in one presence tile");
  // the image's valid instances, compacted in index order
  __shared__ float s_cy[kMaxM], s_cx[kMaxM], s_lt0[kMaxM], s_lt1[kMaxM], s_rb0[kMaxM],
      s_rb1[kMaxM], s_gpos[kMaxM], s_gneg[kMaxM], s_gpull[kMaxM];
  __shared__ int s_slot[kMaxM];
  __shared__ float s_lut[256];
  __shared__ int s_count[kMaxM / 32];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int nw = (W + kTileW - 1) / kTileW;
  const int ntiles = nw * ((H + kTileH - 1) / kTileH);
  const int tile = blockIdx.x / kParts;
  const int r0 = (tile / nw) * kTileH + (blockIdx.x % kParts) * kRows;
  const int c0 = (tile % nw) * kTileW;
  const int row = r0 + tid / (kTileW / 4), col = c0 + (tid % (kTileW / 4)) * 4;
  for (int i = tid; i < 256; i += kBwdThreads) s_lut[i] = lut[i];
  const bool valid = tid < M && tab[((size_t)b * M + tid) * kTabW + kValid] > 0.0f;
  const unsigned ballot = __ballot_sync(0xffffffffu, valid);
  if (tid < kMaxM && tid % 32 == 0) s_count[tid / 32] = __popc(ballot);
  __syncthreads();
  if (valid) {
    int k = __popc(ballot & ((1u << (tid % 32)) - 1u));
    for (int v = 0; v < tid / 32; ++v) k += s_count[v];
    const float* entry = tab + ((size_t)b * M + tid) * kTabW;
    s_cy[k] = entry[kCY];
    s_cx[k] = entry[kCX];
    s_lt0[k] = entry[kLT0];
    s_lt1[k] = entry[kLT1];
    s_rb0[k] = entry[kRB0];
    s_rb1[k] = entry[kRB1];
    s_gpos[k] = g_pos[(size_t)b * M + tid];
    s_gneg[k] = g_neg[(size_t)b * M + tid];
    s_gpull[k] = g_pull[(size_t)b * M + tid];
    s_slot[k] = tid;
  }
  __syncthreads();
  if (row >= H || col >= W) return;              // W % 4 == 0; no block-wide sync follows
  int nv = 0;
  for (int v = 0; v < kMaxM / 32; ++v) nv += s_count[v];

  const uint4 words = cntp[(size_t)b * ntiles + tile];
  const size_t pix = ((size_t)b * H + row) * W + col;
  const size_t slab_pix = (size_t)row * W + col;
  float vey[4], vex[4], vsy[4], vsx[4];
  load4(ey, pix, true, vey); load4(ex, pix, true, vex);
  load4(sy, pix, true, vsy); load4(sx, pix, true, vsx);
  // an instance is visited where its window overlaps the block's rows or it
  // has samples in the tile (uniform across the block)
  auto hit = [&](int k) {
    return (s_lt0[k] < (float)(r0 + kRows) && s_rb0[k] > (float)r0 &&
            s_lt1[k] < (float)(c0 + kTileW) && s_rb1[k] > (float)c0) ||
           present(words, s_slot[k]);
  };

  // pass B: the focal backward (clip mask) over the visited instances, the
  // next one's slab loaded before this one's arithmetic. On the way it
  // marks the pixels holding a sample of some instance: the pull term
  // cnt * |d - dmax| lives there only, and so does dmax.
  float aey[4], aex[4], asy[4], asx[4], gmax[4];
  bool need[4];
  for (int j = 0; j < 4; ++j) {
    aey[j] = aex[j] = asy[j] = asx[j] = gmax[j] = 0.0f;
    need[j] = false;
  }
  int next = 0;
  while (next < nv && !hit(next)) ++next;
  uint3 slab_next = make_uint3(0u, 0u, 0u);
  if (next < nv)
    slab_next = load_slab(r2, cnt, ((size_t)b * M + s_slot[next]) * H * W + slab_pix);
  while (next < nv) {
    const int k = next;
    const uint3 slab = slab_next;
    for (++next; next < nv && !hit(next); ++next) {}
    if (next < nv)
      slab_next = load_slab(r2, cnt, ((size_t)b * M + s_slot[next]) * H * W + slab_pix);
    const float lt1 = s_lt1[k], rb1 = s_rb1[k];
    const float cy = s_cy[k], cx = s_cx[k];
    const float gpos = s_gpos[k], gneg = s_gneg[k];
    const bool row_in = (float)row >= s_lt0[k] && (float)row < s_rb0[k];
    for (int j = 0; j < 4; ++j) {
      const float cv = count_of(slab, j);
      need[j] |= cv != 0.0f;
      const float c = (float)(col + j);
      if (!(row_in && c >= lt1 && c < rb1)) continue;   // outside the window
      const float tv = affinity(vey[j], vex[j], vsy[j], vsx[j], cy, cx);
      if (!(tv >= kEps && tv <= 1.0f - kEps)) continue;  // clipped: pass_g = 0
      const float tc = tv, one_m = 1.0f - tc;
      // one IEEE reciprocal for both divisions: 1/tc = one_m*inv, 1/(1-tc) = tc*inv
      const float inv = __frcp_rn(tc * one_m);
      const float neg4 = s_lut[r2_of(slab, j)];
      const float dneg_dt = neg4 * (2.0f * tc * logf(one_m) - tc * tc * (tc * inv));
      const float dpos_dt = cv > 0.0f
          ? one_m * one_m * (one_m * inv) - 2.0f * one_m * logf(tc) : 0.0f;
      const float gexpo = (gneg * dneg_dt + gpos * dpos_dt) * (-tv);
      const float dy = __fsub_rn(vey[j], cy), dx = __fsub_rn(vex[j], cx);
      aey[j] += gexpo * 2.0f * dy * vsy[j];
      aex[j] += gexpo * 2.0f * dx * vsx[j];
      asy[j] += gexpo * dy * dy;
      asx[j] += gexpo * dx * dx;
    }
  }

  bool any_need = false;
  for (int j = 0; j < 4; ++j) any_need |= need[j];
  if (!any_need) {
    store4(dey, pix, aey); store4(dex, pix, aex);
    store4(dsy, pix, asy); store4(dsx, pix, asx);
    return;
  }

  // pass A: dmax and its first-max center (strict '>' in index order) at
  // the pixels holding samples
  float dmax[4];
  int amax[4];
  for (int j = 0; j < 4; ++j) {
    dmax[j] = 0.0f;
    amax[j] = -1;
  }
  for (int k = 0; k < nv; ++k) {
    const float cy = s_cy[k], cx = s_cx[k];
    for (int j = 0; j < 4; ++j) {
      if (!need[j]) continue;
      const float d = affinity(vey[j], vex[j], vsy[j], vsx[j], cy, cx);
      if (d > dmax[j]) { dmax[j] = d; amax[j] = k; }
    }
  }

  // pass P: the pull's own term for the instances with samples in the
  // tile (their counts again, now from the cache); its dmax cotangent
  // accumulates in gmax
  for (int k = 0; k < nv; ++k) {
    if (!present(words, s_slot[k])) continue;    // uniform across the block
    const uint3 slab = load_slab(r2, cnt, ((size_t)b * M + s_slot[k]) * H * W + slab_pix);
    const float cy = s_cy[k], cx = s_cx[k], gpull = s_gpull[k];
    for (int j = 0; j < 4; ++j) {
      const float cv = count_of(slab, j);
      if (cv == 0.0f) continue;
      const float tv = affinity(vey[j], vex[j], vsy[j], vsx[j], cy, cx);
      const float diff = tv - dmax[j];
      const float sgn = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f);
      const float gpull_own = gpull * cv * sgn;
      gmax[j] -= gpull_own;
      const float gexpo = gpull_own * (-tv);
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
    const float cy = s_cy[amax[j]], cx = s_cx[amax[j]];
    const float d = affinity(vey[j], vex[j], vsy[j], vsx[j], cy, cx);
    const float gexpo = gmax[j] * (-d);
    const float dy = __fsub_rn(vey[j], cy), dx = __fsub_rn(vex[j], cx);
    aey[j] += gexpo * 2.0f * dy * vsy[j];
    aex[j] += gexpo * 2.0f * dx * vsx[j];
    asy[j] += gexpo * dy * dy;
    asx[j] += gexpo * dx * dx;
  }
  store4(dey, pix, aey); store4(dex, pix, aex);
  store4(dsy, pix, asy); store4(dsx, pix, asx);
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
      (const uint4*)cntp, M, H, W, (float*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = B * M * 4;
  ae_reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)partial, B, (int)(grid.x * grid.y), M, (float*)out);
  return (int)cudaGetLastError();
}

// g_pos, g_neg, g_pull: the cotangents [B, M] of pos, neg and pull.
extern "C" int iseg_ae_terms_bwd(const void* ey, const void* ex, const void* sy,
                                 const void* sx, const void* r2, const void* cnt,
                                 const void* tab, const void* lut, const void* cntp,
                                 const void* g_pos, const void* g_neg, const void* g_pull,
                                 int B, int M, int H, int W, void* dey, void* dex, void* dsy,
                                 void* dsx, void* stream) {
  const dim3 tiles = tile_grid(1, H, W);
  const dim3 grid(tiles.x * tiles.y * (kTileH * kTileW / (kBwdThreads * 4)), B);
  ae_bwd_kernel<<<grid, kBwdThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ey, (const float*)ex, (const float*)sy, (const float*)sx,
      (const uint8_t*)r2, (const uint16_t*)cnt, (const float*)tab, (const float*)lut,
      (const uint4*)cntp, (const float*)g_pos, (const float*)g_neg, (const float*)g_pull, M, H,
      W, (float*)dey, (float*)dex, (float*)dsy, (float*)dsx);
  return (int)cudaGetLastError();
}
