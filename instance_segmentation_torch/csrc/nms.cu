// Greedy NMS over a suppression matrix: the keep mask of the decode's
// class-aware NMS (ops/decode.py, leader_nms).
//
// Replaces no TPU kernel. The JAX decode (instance_segmentation_tpu/ops/
// decode.py, leader_nms) runs NMS as a lax.while_loop of whole-array sweeps
// that XLA keeps on the device; run eagerly in PyTorch, each sweep is followed
// by a host read of the loop's condition (4-8 a request), which no CUDA graph
// can hold. This kernel computes the loop's result in one launch with no host
// read.
//
// Input: sup [B, K, K] bool, sup[b, j, i]: keeping box j suppresses box i,
// boxes in rank order; valid [B, K] bool. Output: keep [B, K] bool,
//
//     keep_i = valid_i && !(exists j < i: keep_j && sup[j, i]),
//
// taken in order of i: the sequential greedy result, which is the unique
// fixpoint of leader_nms's sweeps (the caller's sup holds only j < i). The
// kernel reads sup's strict upper triangle and nothing below it, and does no
// float arithmetic: the IoUs and their threshold stay PyTorch's.
//
// What bounds it on the card: not the bytes (the triangle is K(K-1)/2 bytes,
// 131 KB an image at K = 512: 0.04 us at 3.35 TB/s) but the walk's chain of
// dependent steps, which no parallelism shortens: whether box i is kept
// depends on every kept box before it. On an H100 (700 W) a call at K = 512
// takes about 20 us alone, at B = 1 as at B = 8, two thirds of it the walk;
// the sweeps it replaces took about 1 ms a call with their host reads.
//
// The design, one block an image:
//  1. The block packs sup's triangle into bits: word w of row j holds
//     sup[j, 32w .. 32w+31], the bits at and below the diagonal cleared; each
//     thread reads a word's 32 bytes as two 16-byte loads and folds each 4
//     bytes into 4 bits with a multiply (one byte at a time where K is not a
//     multiple of 16 or a row runs out). It packs the validity too. The words
//     live in shared memory where they fit in 48 KB (K up to 608), else in
//     scratch in device memory that the caller allocates.
//  2. One warp walks the boxes 32 at a time, lane t holding box 32c + t of
//     chunk c and the word of its row over the chunk. A mask `supp` of the
//     boxes suppressed by the kept boxes of earlier chunks is complete when
//     the walk reaches chunk c; the chunk's candidates are its valid boxes
//     outside it. Inside the chunk the walk goes box by box over the
//     candidates' bits in registers (32 shuffles). Then each lane ORs the
//     rows of the chunk's kept boxes into one later word of `supp`, reading
//     all 32 rows' words (independent loads, no wait between them) and
//     keeping the kept ones'.
//  A chunk costs a few hundred cycles; at K = 512, 16 chunks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr unsigned kAll = 0xffffffffu;
constexpr size_t kSmemBytes = 48 * 1024;   // what a block gets without opting in

__host__ __device__ inline int words_of(int K) { return (K + 31) / 32; }

// Words an image needs: its rows of packed bits, as many as the chunks hold
// (32 a chunk: the walk reads every row of a chunk, the rows past K unset
// and masked off), then `supp` and the validity bits (a word a chunk each).
__host__ __device__ inline size_t image_words(int K) {
  return ((size_t)32 * words_of(K) + 2) * words_of(K);
}

// 4 bool bytes -> 4 bits, byte k to bit k (any nonzero byte counts as true).
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  const uint32_t t = ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u) >> 7;
  return (t * 0x01020408u) >> 24;
}

// 16 bool bytes -> 16 bits, byte k of the load to bit k.
__device__ __forceinline__ uint32_t pack16(uint4 v) {
  return pack4(v.x) | (pack4(v.y) << 4) | (pack4(v.z) << 8) | (pack4(v.w) << 12);
}

__global__ void __launch_bounds__(kThreads) nms_kernel(
    const uint8_t* __restrict__ sup, const uint8_t* __restrict__ valid, int K,
    uint32_t* __restrict__ scratch, uint8_t* __restrict__ keep) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const int nw = words_of(K);
  uint32_t* bits = scratch ? scratch + (size_t)b * image_words(K) : smem;
  uint32_t* supp = bits + (size_t)32 * nw * nw;
  uint32_t* vbits = supp + nw;
  const uint8_t* img = sup + (size_t)b * K * K;
  const uint8_t* ok = valid + (size_t)b * K;
  const bool vec = ((reinterpret_cast<uintptr_t>(sup) | (uintptr_t)K) & 15) == 0;

  // 1. pack the validity and the strict upper triangle (row j's words from
  //    j / 32 on); clear supp
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < nw; w += kThreads / 32) {
    const int i = 32 * w + lane;
    const uint32_t v = __ballot_sync(kAll, i < K && ok[i] != 0);
    if (lane == 0) {
      vbits[w] = v;
      supp[w] = 0;
    }
  }
  const int total = K * nw;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int j = idx / nw, w = idx - j * nw;
    if (w < (j >> 5)) continue;
    const uint8_t* row = img + (size_t)j * K;
    const int c0 = 32 * w, n = min(32, K - c0);
    uint32_t word = 0;
    if (vec && n == 32) {
      const uint4* p = reinterpret_cast<const uint4*>(row + c0);
      word = pack16(__ldg(p)) | (pack16(__ldg(p + 1)) << 16);
    } else if (vec && n == 16) {
      word = pack16(__ldg(reinterpret_cast<const uint4*>(row + c0)));
    } else {
      for (int c = 0; c < n; ++c) word |= (uint32_t)(row[c0 + c] != 0) << c;
    }
    if (w == (j >> 5)) word &= ~((2u << (j & 31)) - 1u);   // only i > j
    bits[idx] = word;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  // 2. one warp walks the chunks in order
  uint8_t* out = keep + (size_t)b * K;
  for (int c = 0; c < nw; ++c) {
    const int i = 32 * c + lane;
    const uint32_t r = i < K ? bits[(size_t)i * nw + c] : 0u;
    uint32_t cand = vbits[c] & ~supp[c];
#pragma unroll
    for (int t = 0; t < 32; ++t)            // no branch: the shuffles need not wait
      cand &= ~(__shfl_sync(kAll, r, t) & (0u - ((cand >> t) & 1u)));
    if (i < K) out[i] = (uint8_t)((cand >> lane) & 1u);
    for (int w = c + 1 + lane; w < nw; w += 32) {
      const uint32_t* col = bits + (size_t)32 * c * nw + w;
      uint32_t acc = supp[w];
#pragma unroll
      for (int t = 0; t < 32; ++t)            // every row loaded, the kept ones kept
        acc |= col[(size_t)t * nw] & (0u - ((cand >> t) & 1u));
      supp[w] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

// The 32-bit words of scratch the kernel needs for B images of K boxes: 0
// where they fit in shared memory (then pass a null scratch).
extern "C" long long iseg_nms_scratch_words(int B, int K) {
  const size_t words = image_words(K);
  return words * sizeof(uint32_t) <= kSmemBytes ? 0 : (long long)B * (long long)words;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). sup
// [B, K, K] and valid [B, K] are bool, keep [B, K] bool is written; scratch
// holds iseg_nms_scratch_words(B, K) words, or is null where that is 0.
extern "C" int iseg_nms_keep(const void* sup, const void* valid, int B, int K,
                             void* scratch, void* keep, void* stream) {
  if (B < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const bool shared = iseg_nms_scratch_words(B, K) == 0;
  if (!shared && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = shared ? image_words(K) * sizeof(uint32_t) : 0;
  nms_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)sup, (const uint8_t*)valid, K, shared ? nullptr : (uint32_t*)scratch,
      (uint8_t*)keep);
  return (int)cudaGetLastError();
}
