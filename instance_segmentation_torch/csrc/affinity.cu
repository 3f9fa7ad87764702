// Kernel K1: keypoint -> center affinity grouping of the decode.
//
// Replaces the TPU kernel instance_segmentation_tpu/ops/pallas_kernels.py
// affinity_assign (_affinity_kernel) and computes the JAX decode's grouping
// expression (ops/decode.py: scored = dists * contained, then jnp.argmax and
// the max) by its own rules. For keypoint k of image b and center d,
//
//     score(k, d) = exp(-((e0-c0)^2 * s0 + (e1-c1)^2 * s1)) * contained(k, d)
//     contained   = y1 <= row <= y2 && x1 <= col <= x2 && det_valid[d]
//
// assign[k] is the first d of the largest score, a NaN counting above every
// number (numpy's argmax, and jnp.argmax op by op), and best[k] that score.
// NaN * 0 is NaN, so a NaN can come from a pair outside its box (under
// jax.jit, XLA rewrites the product into a select and scores such a pair 0).
// Scores are >= 0 or NaN, so a keypoint whose scores are all 0 (in no box,
// or every contained score underflowing) gets slot 0.
//
// What bounds it on the card: the bytes would. A keypoint reads 24 B
// (row/col, embedding, sigma) and writes 8 B: 5.1 MB at B=8, K=20000, 1.5 us
// at 3.35 TB/s; the center table is a few KB an image. But reading and
// writing them alone, with this grid, takes about twice that, and what the
// culling and scoring add is instruction issue and the latency of the
// slowest warp (all warps run in one wave), not bytes. The work the function
// needs is a containment test per (keypoint, valid center) pair and an
// exponential per contained pair, and a keypoint lies in a few boxes.
// Scoring every pair with expf, as the first version of this kernel did,
// took 20x the bytes' time.
//
// The design:
//  - A block stages its image's center table in shared memory (a box as a
//    float4 whose y1 is NaN for an invalid detection, so that no keypoint
//    lies in it; c_emb; a bit mask of the centers whose c_emb is not finite).
//  - A warp takes 32 keypoints and keeps, 32 centers at a time (ballot), the
//    centers whose box meets its keypoints' bounding rectangle. Exact for any
//    keypoint order; the decode hands the keypoints over in ascending pixel
//    order, so a warp's keypoints lie in one or two image rows and few boxes
//    meet them.
//  - Each lane tests its keypoint against the kept centers, four at a time
//    (independent loads). Where more than kDense centers of a chunk are kept
//    (keypoints spread over many rows), the lanes take the chunk's centers
//    instead and test each against the warp's 32 keypoints, one ballot a
//    keypoint. Either way a lane ends with a bit mask of the boxes holding
//    its keypoint, takes the exponential for those pairs only and keeps its
//    argmax in registers.
//  - The first-max argmax is order-free: a 64-bit key (score bits << 32 |
//    0xffffffff - d), NaN canonicalised to 0x7fc00000, above +inf, so the
//    first NaN wins. The key starts at (score 0, d = 0): slot 0 wins wherever
//    no score is above 0, as the first maximum of all-zero scores does.
//
// NaN outside the box: a pair outside scores exp(-expo) * 0, which is 0
// unless expo is NaN or below -88 (exp overflowing). With e finite, sig in
// (0, inf) and c_emb finite, each term of expo lies in [0, inf] (dy may
// overflow to +-inf and dy^2 to inf, times a positive finite sig is inf,
// never NaN), so the outside score is 0 and skipping the pair is exact.
// Otherwise the pair is scored: a center whose c_emb is not finite is scored
// for every keypoint (invalid detections too: NaN * 0 is NaN), and a keypoint
// whose emb is not finite or whose sig is not in (0, inf) ("odd") is scored
// against every center, the warp's 32 lanes sharing its centers.
//
// Exactness: the products and sums use __fmul_rn/__fadd_rn so the compiler
// cannot contract them into FMAs the plain version does not do; expf is the
// full-precision CUDA function (built without --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDense = 12;                  // kept centers of a chunk beyond which lanes take centers
constexpr int kMaxCenters = 1024;
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned long long kSeed = 0xffffffffull;   // score 0, slot 0

// An int ordered as the float is (for floats that are not NaN).
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float from_ordered(int i) {
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}

// The score of (e, s) against center c, times 1 inside the box and 0
// outside, in the plain version's order of operations.
__device__ __forceinline__ float score(float2 e, float2 s, float2 c, bool inside) {
  const float dy = __fsub_rn(e.x, c.x);
  const float dx = __fsub_rn(e.y, c.y);
  const float expo = __fadd_rn(__fmul_rn(__fmul_rn(dy, dy), s.x),
                               __fmul_rn(__fmul_rn(dx, dx), s.y));
  return __fmul_rn(expf(-expo), inside ? 1.0f : 0.0f);
}

// The larger of `key` and the key of (score, d).
__device__ __forceinline__ unsigned long long keep_max(unsigned long long key, float score, int d) {
  const unsigned bits = isnan(score) ? 0x7fc00000u : __float_as_uint(score);
  const unsigned long long k = ((unsigned long long)bits << 32) | (kAll - (unsigned)d);
  return k > key ? k : key;
}

__device__ __forceinline__ bool in_box(float2 rc, float4 box) {
  return rc.x >= box.x && rc.x <= box.z && rc.y >= box.y && rc.y <= box.w;
}

__global__ void __launch_bounds__(kThreads)
affinity_kernel(const float2* __restrict__ kp_rc,     // [B, K] (row, col)
                const float2* __restrict__ emb,       // [B, K]
                const float2* __restrict__ sig,       // [B, K]
                const float* __restrict__ c_emb,      // [B, D, 2]
                const float* __restrict__ boxes,      // [B, D, 4] (x1, y1, x2, y2)
                const uint8_t* __restrict__ det_valid,  // [B, D] bool
                int K, int D,
                int32_t* __restrict__ assign,         // [B, K]
                float* __restrict__ best) {           // [B, K]
  extern __shared__ __align__(16) unsigned char smem[];
  float4* box = reinterpret_cast<float4*>(smem);                  // [D] y1, x1, y2, x2
  float2* cen = reinterpret_cast<float2*>(box + D);               // [D] c_emb
  unsigned* odd_centers = reinterpret_cast<unsigned*>(cen + D);   // [kMaxCenters / 32]

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const bool active = k < K;
  const size_t p = (size_t)b * K + k;
  float2 rc = make_float2(NAN, NAN), e = make_float2(0.f, 0.f), s = make_float2(1.f, 1.f);
  if (active) {
    rc = kp_rc[p];
    e = emb[p];
    s = sig[p];
  }

  for (int d0 = 0; d0 < D; d0 += kThreads) {
    const int d = d0 + threadIdx.x;
    bool odd_center = false;
    if (d < D) {
      const size_t c = (size_t)b * D + d;
      const float c0 = c_emb[2 * c], c1 = c_emb[2 * c + 1];
      box[d] = make_float4(det_valid[c] ? boxes[4 * c + 1] : NAN, boxes[4 * c + 0],
                           boxes[4 * c + 3], boxes[4 * c + 2]);
      cen[d] = make_float2(c0, c1);
      odd_center = !(isfinite(c0) && isfinite(c1));
    }
    const unsigned word = __ballot_sync(kAll, odd_center);
    if (lane == 0 && d < D) odd_centers[d >> 5] = word;
  }
  __syncthreads();

  // an odd keypoint: its pairs outside the boxes may be NaN (see above)
  const bool odd = active && !(isfinite(e.x) && isfinite(e.y) && s.x > 0.f && s.y > 0.f &&
                               s.x < INFINITY && s.y < INFINITY);
  unsigned long long key = kSeed;

  // each odd keypoint of the warp against every center, 32 centers at a time
  for (unsigned odds = __ballot_sync(kAll, odd); odds; odds &= odds - 1) {
    const int owner = __ffs(odds) - 1;
    const float2 orc = make_float2(__shfl_sync(kAll, rc.x, owner), __shfl_sync(kAll, rc.y, owner));
    const float2 oe = make_float2(__shfl_sync(kAll, e.x, owner), __shfl_sync(kAll, e.y, owner));
    const float2 os = make_float2(__shfl_sync(kAll, s.x, owner), __shfl_sync(kAll, s.y, owner));
    unsigned long long top = kSeed;
    for (int d = lane; d < D; d += 32)
      top = keep_max(top, score(oe, os, cen[d], in_box(orc, box[d])), d);
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long other =
          ((unsigned long long)__shfl_xor_sync(kAll, (unsigned)(top >> 32), o) << 32) |
          __shfl_xor_sync(kAll, (unsigned)top, o);
      top = other > top ? other : top;
    }
    if (lane == owner) key = top;
  }

  // the bounding rectangle of the warp's other keypoints (a NaN row or
  // column lies in no box)
  const bool placed = active && !odd && !isnan(rc.x) && !isnan(rc.y);
  const float rmin = from_ordered(__reduce_min_sync(kAll, ordered(placed ? rc.x : INFINITY)));
  const float rmax = from_ordered(__reduce_max_sync(kAll, ordered(placed ? rc.x : -INFINITY)));
  const float cmin = from_ordered(__reduce_min_sync(kAll, ordered(placed ? rc.y : INFINITY)));
  const float cmax = from_ordered(__reduce_max_sync(kAll, ordered(placed ? rc.y : -INFINITY)));
  const unsigned regular = active && !odd ? kAll : 0u;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const float4 mine = d0 + lane < D ? box[d0 + lane] : make_float4(NAN, NAN, NAN, NAN);
    const bool meets = mine.x <= rmax && mine.z >= rmin && mine.y <= cmax && mine.w >= cmin;
    const unsigned always = odd_centers[d0 >> 5];
    unsigned inside = 0;                     // bit i: the keypoint lies in box d0 + i
    unsigned kept = __ballot_sync(kAll, meets) | always;
    if (__popc(kept) > kDense) {
      // many kept: each lane tests its center against the warp's keypoints,
      // one ballot a keypoint
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const float2 q = make_float2(__shfl_sync(kAll, rc.x, j), __shfl_sync(kAll, rc.y, j));
        const unsigned m = __ballot_sync(kAll, in_box(q, mine));
        inside = lane == j ? m : inside;
      }
    } else {
      // few kept: each lane tests its keypoint against them, four at a time
      while (kept) {
        const int b0 = __ffs(kept) - 1;
        kept &= kept - 1;
        const int b1 = kept ? __ffs(kept) - 1 : b0;
        kept &= kept - 1;
        const int b2 = kept ? __ffs(kept) - 1 : b0;
        kept &= kept - 1;
        const int b3 = kept ? __ffs(kept) - 1 : b0;
        kept &= kept - 1;
        const float4 x0 = box[d0 + b0], x1 = box[d0 + b1], x2 = box[d0 + b2], x3 = box[d0 + b3];
        inside |= ((unsigned)in_box(rc, x0) << b0) | ((unsigned)in_box(rc, x1) << b1) |
                  ((unsigned)in_box(rc, x2) << b2) | ((unsigned)in_box(rc, x3) << b3);
      }
    }
    inside &= regular;
    for (unsigned scored = inside | (always & regular); scored; scored &= scored - 1) {
      const int bit = __ffs(scored) - 1;
      key = keep_max(key, score(e, s, cen[d0 + bit], (inside >> bit) & 1), d0 + bit);
    }
  }

  if (active) {
    assign[p] = (int32_t)(kAll - (unsigned)key);
    best[p] = __uint_as_float((unsigned)(key >> 32));
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// keypoint arrays must be 8-byte aligned; 1 <= D <= 1024.
extern "C" int iseg_affinity_assign(const void* kp_rc, const void* emb,
                                    const void* sig, const void* c_emb,
                                    const void* boxes, const void* det_valid,
                                    int B, int K, int D, void* assign,
                                    void* best, void* stream) {
  if (D < 1 || D > kMaxCenters) return (int)cudaErrorInvalidValue;
  const dim3 grid((K + kThreads - 1) / kThreads, B);
  const size_t smem = (sizeof(float4) + sizeof(float2)) * D + sizeof(unsigned) * kMaxCenters / 32;
  affinity_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)kp_rc, (const float2*)emb, (const float2*)sig, (const float*)c_emb,
      (const float*)boxes, (const uint8_t*)det_valid, K, D, (int32_t*)assign, (float*)best);
  return (int)cudaGetLastError();
}
