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
// center (strict '>' in index order), as the TPU kernel does. An instance
// that is not valid has no window, so its focal terms are 0; where it has
// samples all the same (the loss never builds such input), its pull is
// summed and differentiated like any other, dmax still over the valid
// centers, as the TPU kernel and the plain twin do.
//
// What bounds them on the card: less the bytes than the issue of their
// arithmetic (per visited pixel and instance an expf, one or two logf and
// the focal products, some 80 instructions) and the latency of dependent
// loads. Work goes by 16 x 64 tiles (4 adjacent pixels a thread, vector loads). An
// instance is visited in a tile only where its window overlaps the tile or
// it has samples there (the presence bitmask from the point list, [B,
// ntiles, 4] words, bit m for instance m), the TPU kernel's skip rule, so the
// ~805 MB count map is read only where it matters. Both kernels stage their
// image's valid instances once per block, compacted in index order
// (stage_instances), decide the visits by one test uniform across the block
// (visits), run the focal pass first with the next visited instance's slab
// loaded before this one's arithmetic, mark there the pixels holding a
// sample, and compute dmax (first_max) and the pull term at those pixels
// only: cnt is 0 everywhere else, so the pull lives there alone. The
// instances that are not valid are staged after the valid ones with an
// empty window: only the tiles holding their samples visit them, for the
// pull alone: a block stages only those with samples in its tile (none on
// the loss's path). Pixels holding a sample are few, so
// first_max spreads a warp's marked pixels over its lanes and walks the
// centers once for them all. Each block loads its tile's presence words
// before the staging and each table row in two 16-byte loads.
//
// K3 gives a block one tile. A tile that no instance visits reads no field
// and writes nothing. Each warp reduces an instance's sums with shuffles into
// shared memory, no block-wide barrier per instance; one barrier at the end
// sums the warps in a fixed order and writes one partial per visited (tile,
// instance) pair, [B, M, ntiles] float4 (partial_at). A second kernel gives
// each (image, instance) a block that walks its tiles contiguously, adds the
// partials of the tiles the same test visits (so unvisited pairs need no
// zeros) and sums its threads in a fixed tree: no float atomics, the same
// bits every launch. The four sums go to four [B, M] outputs the wrapper
// allocates: no PyTorch kernel runs inside the call.
//
// K4's blocks are smaller (128 threads, half a tile, 80 registers so six
// blocks fit an SM): it is bound by the latency of its dependent loads more
// than by its arithmetic. It stages the three cotangents beside the table,
// shares one IEEE reciprocal between the two divisions of the focal
// derivatives, and routes the dmax cotangent to the first max. Every pixel's
// gradient is written by one thread, no atomics.
//
// The affinity is computed with __fmul_rn/__fadd_rn everywhere it appears so
// that the forward, dmax and the backward see the same bits; expf/logf are
// the full-precision functions (no --use_fast_math).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                    // K3's block: one tile
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 16;
constexpr int kTileW = 64;                       // 16 threads x 4 columns
constexpr int kMaxM = 128;
constexpr float kEps = 1e-4f;
enum { kCY, kCX, kLT0, kLT1, kRB0, kRB1, kValid };   // fields of a table row
constexpr int kTabW = 8;                         // floats per table row (one unused)
constexpr int kSumThreads = 256;                 // K3's cross-tile sum: a block per (b, m)
constexpr int kBwdThreads = 128;                 // K4's block
constexpr int kBwdMinBlocks = 6;                 // K4: blocks an SM should hold
constexpr unsigned kFull = 0xffffffffu;
static_assert(kMaxM == 4 * 32, "a tile's presence is one uint4 (4 words of 32 instances)");
static_assert(kThreads == kTileH * kTileW / 4, "K3: a thread per 4 pixels of its tile");
static_assert(kThreads >= kMaxM && kBwdThreads >= kMaxM,
              "stage_instances takes one table entry a thread");

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

// Whether a block covering rows [r0, r0 + rows) and columns [c0, c0 +
// kTileW) visits an instance with window (lt, rb): the window overlaps them,
// or the instance has samples in the presence tile (pts). K3, its cross-tile
// sum and K4 all decide by this test.
__device__ __forceinline__ bool visits(float lt0, float lt1, float rb0, float rb1, int r0,
                                       int rows, int c0, bool pts) {
  return (lt0 < (float)(r0 + rows) && rb0 > (float)r0 && lt1 < (float)(c0 + kTileW) &&
          rb1 > (float)c0) || pts;
}

// A block's instances, the valid ones first, each kind compacted in index
// order, and the (1-g)^4 table: what K3 and K4 stage once per block.
struct Instances {
  float cy[kMaxM], cx[kMaxM], lt0[kMaxM], lt1[kMaxM], rb0[kMaxM], rb1[kMaxM];
  int slot[kMaxM];                               // entry k's instance index
  int count[kMaxM / 32], rest[kMaxM / 32];       // valid and other entries a warp
  float lut[256];
};

// Called by every thread of the block (blockDim.x >= kMaxM, whole warps);
// ends in a barrier. Valid instance m becomes entry k, its rank among the
// valid ones. The nv valid ones are followed by the others that have
// samples in the block's tile (presence words w), entries nv to n - 1, each
// with an empty window (visits() takes them for their samples only).
// extra(k, m) stages a kernel's own fields of entry k. Returns nv.
template <class Extra>
__device__ __forceinline__ int stage_instances(const float* __restrict__ tab,
                                               const float* __restrict__ lut, int b, int M,
                                               const uint4& w, Instances& s, int& n,
                                               Extra extra) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += blockDim.x) s.lut[i] = lut[i];
  // the whole row in two 16-byte loads, before its valid flag is known
  float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
  if (tid < M) {
    const float4* row = reinterpret_cast<const float4*>(tab + ((size_t)b * M + tid) * kTabW);
    lo = row[0];
    hi = row[1];
  }
  static_assert(kCY == 0 && kLT1 == 3 && kValid == 6 && kTabW == 8, "the row's layout");
  const bool valid = hi.z > 0.0f;                // kValid (0 past M)
  const unsigned ballot = __ballot_sync(kFull, valid);
  const bool other = tid < M && !valid && present(w, tid);
  const unsigned others = __ballot_sync(kFull, other);
  if (tid < kMaxM && tid % 32 == 0) {
    s.count[tid / 32] = __popc(ballot);
    s.rest[tid / 32] = __popc(others);
  }
  __syncthreads();
  int nv = 0;
  n = 0;
  for (int v = 0; v < kMaxM / 32; ++v) {
    nv += s.count[v];
    n += s.rest[v];
  }
  n += nv;
  if (valid || other) {
    const unsigned below = (1u << (tid % 32)) - 1u;
    int k = valid ? __popc(ballot & below) : nv + __popc(others & below);
    for (int v = 0; v < tid / 32; ++v) k += valid ? s.count[v] : s.rest[v];
    s.cy[k] = lo.x;
    s.cx[k] = lo.y;
    s.lt0[k] = valid ? lo.z : CUDART_INF_F;
    s.lt1[k] = valid ? lo.w : CUDART_INF_F;
    s.rb0[k] = valid ? hi.x : -CUDART_INF_F;
    s.rb1[k] = valid ? hi.y : -CUDART_INF_F;
    s.slot[k] = tid;
    extra(k, tid);
  }
  __syncthreads();
  return nv;
}

// dmax over the staged centers and its first max (strict '>' in index
// order; -1 where no center gives more than 0) at the pixels marked need.
// The warp's marked pixels, in (j, lane) order, are spread over its lanes,
// one a lane per round (the fields come from their owner lanes by shuffles,
// the results go back the same way): a pixel holding a sample is rare, so
// one round usually does what four divergent passes over j would.
__device__ __forceinline__ void first_max(const Instances& s, int nv, const float* vey,
                                          const float* vex, const float* vsy, const float* vsx,
                                          const bool* need, float* dmax, int* amax) {
  const int lane = threadIdx.x % 32;
  unsigned marked[4];
  int base[4], total = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    marked[j] = __ballot_sync(kFull, need[j]);
    base[j] = total;
    total += __popc(marked[j]);
    dmax[j] = 0.0f;
    amax[j] = -1;
  }
  for (int r = 0; r < total; r += 32) {          // uniform across the warp
    const int q = r + lane;                      // the marked pixel this lane takes
    const int jq = (q >= base[1]) + (q >= base[2]) + (q >= base[3]);
    const bool mine = q < total;
    const int owner = mine ? (int)__fns(marked[jq], 0u, q - base[jq] + 1) : 0;
    float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};       // ey, ex, sy, sx at that pixel
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float fy = __shfl_sync(kFull, vey[j], owner), fx = __shfl_sync(kFull, vex[j], owner);
      const float gy = __shfl_sync(kFull, vsy[j], owner), gx = __shfl_sync(kFull, vsx[j], owner);
      if (j == jq) { e[0] = fy; e[1] = fx; e[2] = gy; e[3] = gx; }
    }
    float best = 0.0f;
    int arg = -1;
    if (mine) {
      for (int k = 0; k < nv; ++k) {
        const float d = affinity(e[0], e[1], e[2], e[3], s.cy[k], s.cx[k]);
        if (d > best) { best = d; arg = k; }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {                // back to the owners
      const int src = base[j] + __popc(marked[j] & ((1u << lane) - 1u)) - r;
      const float got = __shfl_sync(kFull, best, src & 31);
      const int at = __shfl_sync(kFull, arg, src & 31);
      if (need[j] && src >= 0 && src < 32) { dmax[j] = got; amax[j] = at; }
    }
  }
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

// Marks need at the samples of the instances that are not valid (entries
// nv to n - 1): their pull needs dmax there too. at(k) is the offset of
// entry k's 4 pixels in r2 and cnt.
template <class At>
__device__ __forceinline__ void mark_other_samples(int nv, int n, bool ok,
                                                   const uint8_t* __restrict__ r2,
                                                   const uint16_t* __restrict__ cnt, At at,
                                                   bool* need) {
  for (int k = nv; k < n && ok; ++k) {
    const uint3 slab = load_slab(r2, cnt, at(k));
#pragma unroll
    for (int j = 0; j < 4; ++j) need[j] |= count_of(slab, j) != 0.0f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;                                      // complete in lane 0
}

// K3's scratch: the float4 partial of instance bm (b * M + m) in tile t,
// [B, M, ntiles].
__host__ __device__ __forceinline__ size_t partial_at(size_t bm, int ntiles, int t) {
  return bm * ntiles + t;
}

// K3: a block per 16 x 64 tile, 4 adjacent pixels a thread.
__global__ void __launch_bounds__(kThreads)
ae_fwd_kernel(const float* __restrict__ ey, const float* __restrict__ ex,
              const float* __restrict__ sy, const float* __restrict__ sx,   // [B, H, W]
              const uint8_t* __restrict__ r2, const uint16_t* __restrict__ cnt,  // [B, M, H, W]
              const float* __restrict__ tab,     // [B, M, 8]
              const float* __restrict__ lut,     // [256]
              const uint4* __restrict__ cntp,    // [B, ntiles]: presence bits
              int M, int H, int W,
              float4* __restrict__ partial) {    // [B, M, ntiles]: visited pairs only
  __shared__ Instances s;
  __shared__ float4 s_part[kWarps][kMaxM];       // (pos, neg, npos, pull) per warp
  const int b = blockIdx.y, tile = blockIdx.x, ntiles = gridDim.x, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int nw = (W + kTileW - 1) / kTileW;
  const int r0 = (tile / nw) * kTileH, c0 = (tile % nw) * kTileW;
  const int row = r0 + tid / (kTileW / 4), col = c0 + (tid % (kTileW / 4)) * 4;
  const bool ok = row < H && col < W;            // W % 4 == 0: all 4 columns or none
  const uint4 words = cntp[(size_t)b * ntiles + tile];   // in flight during the staging
  int n;
  const int nv = stage_instances(tab, lut, b, M, words, s, n, [](int, int) {});
  auto hit = [&](int k) {                        // uniform across the block
    return visits(s.lt0[k], s.lt1[k], s.rb0[k], s.rb1[k], r0, kTileH, c0,
                  present(words, s.slot[k]));
  };
  int next = 0;
  while (next < n && !hit(next)) ++next;
  if (next == n) return;                         // no visit: no field read, nothing written

  const size_t pix = ((size_t)b * H + row) * W + col;
  const size_t slab_pix = (size_t)row * W + col;
  const size_t slabs = (size_t)b * M;
  auto at = [&](int k) { return (slabs + s.slot[k]) * H * W + slab_pix; };
  float vey[4], vex[4], vsy[4], vsx[4];
  load4(ey, pix, ok, vey); load4(ex, pix, ok, vex);
  load4(sy, pix, ok, vsy); load4(sx, pix, ok, vsx);
  uint3 slab_next = make_uint3(0u, 0u, 0u);
  if (next < nv && ok) slab_next = load_slab(r2, cnt, at(next));

  // the focal pass over the visited instances, the next one's slab loaded
  // before this one's arithmetic; it marks the pixels holding samples
  bool need[4] = {false, false, false, false};
  while (next < nv) {
    const int k = next;
    const uint3 slab = slab_next;
    for (++next; next < nv && !hit(next); ++next) {}
    if (next < nv && ok) slab_next = load_slab(r2, cnt, at(next));
    const float lt1 = s.lt1[k], rb1 = s.rb1[k], cy = s.cy[k], cx = s.cx[k];
    const bool row_in = ok && (float)row >= s.lt0[k] && (float)row < s.rb0[k];
    float pos = 0.0f, neg = 0.0f;
    int npos = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float cv = count_of(slab, j);
      need[j] |= cv != 0.0f;
      const float c = (float)(col + j);
      if (!(row_in && c >= lt1 && c < rb1)) continue;   // outside the window
      const float d = affinity(vey[j], vex[j], vsy[j], vsx[j], cy, cx);
      const float pred = fminf(fmaxf(d, kEps), 1.0f - kEps);
      neg += logf(1.0f - pred) * pred * pred * s.lut[r2_of(slab, j)];
      if (cv > 0.0f) {
        pos += logf(pred) * (1.0f - pred) * (1.0f - pred);
        ++npos;
      }
    }
    pos = warp_sum(pos);
    neg = warp_sum(neg);
    npos = __reduce_add_sync(kFull, npos);
    if (lane == 0) s_part[warp][k] = make_float4(pos, neg, (float)npos, 0.0f);
  }

  // dmax at the pixels holding samples, then the pull of the instances
  // with samples in the tile (their counts again, from the cache, the
  // next one's loaded before this one's arithmetic)
  mark_other_samples(nv, n, ok, r2, cnt, at, need);
  float dmax[4];
  int amax[4];
  first_max(s, nv, vey, vex, vsy, vsx, need, dmax, amax);
  next = 0;
  while (next < n && !present(words, s.slot[next])) ++next;
  if (next < n && ok) slab_next = load_slab(r2, cnt, at(next));
  while (next < n) {
    const int k = next;
    const uint3 slab = slab_next;
    for (++next; next < n && !present(words, s.slot[next]); ++next) {}
    if (next < n && ok) slab_next = load_slab(r2, cnt, at(next));
    const float cy = s.cy[k], cx = s.cx[k];
    float pull = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float cv = count_of(slab, j);
      if (!ok || cv == 0.0f) continue;
      pull += cv * fabsf(affinity(vey[j], vex[j], vsy[j], vsx[j], cy, cx) - dmax[j]);
    }
    pull = warp_sum(pull);
    if (lane == 0) {                             // no focal pass for the others
      if (k < nv) s_part[warp][k].w = pull;
      else s_part[warp][k] = make_float4(0.0f, 0.0f, 0.0f, pull);
    }
  }

  // one barrier: the warps' sums, in warp order, one partial per visit
  __syncthreads();
  for (int k = tid; k < n; k += kThreads) {
    if (!hit(k)) continue;
    float4 sum = s_part[0][k];
    for (int v = 1; v < kWarps; ++v) {
      const float4 q = s_part[v][k];
      sum.x += q.x; sum.y += q.y; sum.z += q.z; sum.w += q.w;
    }
    partial[partial_at(slabs + s.slot[k], ntiles, tile)] = sum;
  }
}

// K3's cross-tile sum: a block per (instance, image) walks the tiles in
// order, adds the partials of the tiles that visit the instance (the test
// of ae_fwd_kernel, an instance that is not valid with the empty window
// stage_instances gives it) and sums its threads in a fixed tree.
__global__ void __launch_bounds__(kSumThreads)
ae_sum_kernel(const float4* __restrict__ partial,  // [B, M, ntiles]
              const float* __restrict__ tab,       // [B, M, 8]
              const uint32_t* __restrict__ cntp,   // [B, ntiles, 4]: presence words
              int M, int W, int ntiles,
              float* __restrict__ pos, float* __restrict__ neg, float* __restrict__ npos,
              float* __restrict__ pull) {          // [B, M] each
  __shared__ float4 s_warp[kSumThreads / 32];
  const int m = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t bm = (size_t)b * M + m;
  const float* entry = tab + bm * kTabW;
  const int nw = (W + kTileW - 1) / kTileW;
  const bool valid = entry[kValid] > 0.0f;
  const float lt0 = valid ? entry[kLT0] : CUDART_INF_F, lt1 = valid ? entry[kLT1] : CUDART_INF_F;
  const float rb0 = valid ? entry[kRB0] : -CUDART_INF_F, rb1 = valid ? entry[kRB1] : -CUDART_INF_F;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int t = tid; t < ntiles; t += kSumThreads) {
    const bool pts = (cntp[((size_t)b * ntiles + t) * 4 + m / 32] >> (m % 32)) & 1u;
    if (!visits(lt0, lt1, rb0, rb1, (t / nw) * kTileH, kTileH, (t % nw) * kTileW, pts))
      continue;
    const float4 q = partial[partial_at(bm, ntiles, t)];
    acc.x += q.x; acc.y += q.y; acc.z += q.z; acc.w += q.w;
  }
  acc.x = warp_sum(acc.x);
  acc.y = warp_sum(acc.y);
  acc.z = warp_sum(acc.z);
  acc.w = warp_sum(acc.w);
  if (tid % 32 == 0) s_warp[tid / 32] = acc;
  __syncthreads();
  if (tid == 0) {
    float4 sum = s_warp[0];
    for (int v = 1; v < kSumThreads / 32; ++v) {
      sum.x += s_warp[v].x; sum.y += s_warp[v].y; sum.z += s_warp[v].z; sum.w += s_warp[v].w;
    }
    pos[bm] = sum.x;
    neg[bm] = sum.y;
    npos[bm] = sum.z;
    pull[bm] = sum.w;
  }
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
  __shared__ Instances s;
  __shared__ float s_gpos[kMaxM], s_gneg[kMaxM], s_gpull[kMaxM];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int nw = (W + kTileW - 1) / kTileW;
  const int ntiles = nw * ((H + kTileH - 1) / kTileH);
  const int tile = blockIdx.x / kParts;
  const int r0 = (tile / nw) * kTileH + (blockIdx.x % kParts) * kRows;
  const int c0 = (tile % nw) * kTileW;
  const int row = r0 + tid / (kTileW / 4), col = c0 + (tid % (kTileW / 4)) * 4;
  const uint4 words = cntp[(size_t)b * ntiles + tile];   // in flight during the staging
  int n;
  const int nv = stage_instances(tab, lut, b, M, words, s, n, [&](int k, int m) {
    s_gpos[k] = g_pos[(size_t)b * M + m];
    s_gneg[k] = g_neg[(size_t)b * M + m];
    s_gpull[k] = g_pull[(size_t)b * M + m];
  });
  // W % 4 == 0: all 4 columns or none. A lane outside the image stays: the
  // warp's shuffles in first_max need all its lanes.
  const bool ok = row < H && col < W;

  const size_t pix = ((size_t)b * H + row) * W + col;
  const size_t slab_pix = (size_t)row * W + col;
  auto at = [&](int k) { return ((size_t)b * M + s.slot[k]) * H * W + slab_pix; };
  float vey[4], vex[4], vsy[4], vsx[4];
  load4(ey, pix, ok, vey); load4(ex, pix, ok, vex);
  load4(sy, pix, ok, vsy); load4(sx, pix, ok, vsx);
  auto hit = [&](int k) {                        // uniform across the block
    return visits(s.lt0[k], s.lt1[k], s.rb0[k], s.rb1[k], r0, kRows, c0,
                  present(words, s.slot[k]));
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
  if (next < nv && ok) slab_next = load_slab(r2, cnt, at(next));
  while (next < nv) {
    const int k = next;
    const uint3 slab = slab_next;
    for (++next; next < nv && !hit(next); ++next) {}
    if (next < nv && ok) slab_next = load_slab(r2, cnt, at(next));
    const float lt1 = s.lt1[k], rb1 = s.rb1[k];
    const float cy = s.cy[k], cx = s.cx[k];
    const float gpos = s_gpos[k], gneg = s_gneg[k];
    const bool row_in = ok && (float)row >= s.lt0[k] && (float)row < s.rb0[k];
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
      const float neg4 = s.lut[r2_of(slab, j)];
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

  mark_other_samples(nv, n, ok, r2, cnt, at, need);
  bool any_need = false;
  for (int j = 0; j < 4; ++j) any_need |= need[j];
  if (!__any_sync(kFull, any_need)) {           // uniform across the warp
    if (ok) {
      store4(dey, pix, aey); store4(dex, pix, aex);
      store4(dsy, pix, asy); store4(dsx, pix, asx);
    }
    return;
  }

  // pass A: dmax and its first-max center at the pixels holding samples
  float dmax[4];
  int amax[4];
  first_max(s, nv, vey, vex, vsy, vsx, need, dmax, amax);

  // pass P: the pull's own term for the instances with samples in the
  // tile, the ones that are not valid included (their counts again, now
  // from the cache); its dmax cotangent accumulates in gmax
  for (int k = 0; k < n; ++k) {
    if (!present(words, s.slot[k])) continue;    // uniform across the block
    const uint3 slab = ok ? load_slab(r2, cnt, at(k)) : make_uint3(0u, 0u, 0u);
    const float cy = s.cy[k], cx = s.cx[k], gpull = s_gpull[k];
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
    const float cy = s.cy[amax[j]], cx = s.cx[amax[j]];
    const float d = affinity(vey[j], vex[j], vsy[j], vsx[j], cy, cx);
    const float gexpo = gmax[j] * (-d);
    const float dy = __fsub_rn(vey[j], cy), dx = __fsub_rn(vex[j], cx);
    aey[j] += gexpo * 2.0f * dy * vsy[j];
    aex[j] += gexpo * 2.0f * dx * vsx[j];
    asy[j] += gexpo * dy * dy;
    asx[j] += gexpo * dx * dx;
  }
  if (ok) {
    store4(dey, pix, aey); store4(dex, pix, aex);
    store4(dsy, pix, asy); store4(dsx, pix, asx);
  }
}

dim3 tile_grid(int B, int H, int W) {
  return dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int iseg_ae_tiles(int H, int W) {
  const dim3 g = tile_grid(1, H, W);
  return (int)(g.x * g.y);
}

// The floats of K3's scratch, `partial`: a float4 for each (image,
// instance, tile), of which K3 writes and reads the visited ones only.
extern "C" long long iseg_ae_partial_floats(int B, int M, int H, int W) {
  return (long long)partial_at((size_t)B * M, iseg_ae_tiles(H, W), 0) *
         (sizeof(float4) / sizeof(float));
}

// `partial` is scratch of iseg_ae_partial_floats floats; pos, neg, npos and
// pull are the [B, M] outputs. Two launches.
extern "C" int iseg_ae_terms_fwd(const void* ey, const void* ex, const void* sy,
                                 const void* sx, const void* r2, const void* cnt,
                                 const void* tab, const void* lut, const void* cntp,
                                 int B, int M, int H, int W, void* partial, void* pos,
                                 void* neg, void* npos, void* pull, void* stream) {
  const int ntiles = iseg_ae_tiles(H, W);
  ae_fwd_kernel<<<dim3(ntiles, B), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ey, (const float*)ex, (const float*)sy, (const float*)sx,
      (const uint8_t*)r2, (const uint16_t*)cnt, (const float*)tab, (const float*)lut,
      (const uint4*)cntp, M, H, W, (float4*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ae_sum_kernel<<<dim3(M, B), kSumThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)partial, (const float*)tab, (const uint32_t*)cntp, M, W, ntiles,
      (float*)pos, (float*)neg, (float*)npos, (float*)pull);
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
