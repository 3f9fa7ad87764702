// Eval batch norm and the squeeze-and-excitation gate as one pass over an
// activation: y = act(round(round(x * s) + t)), every step rounded to the
// working type as PyTorch's composition rounds it (models/layers.py,
// BatchNorm: x * scale + shift, then F.silu, F.relu or F.gelu; MBConv's
// sigmoid(s) * x), so the kernel gives the composition's bits.
//
// Replaces no TPU kernel: XLA fuses the JAX package's batch norm and
// activation into the convolution's neighbours. In PyTorch the composition
// is two or three passes over the activation, the broadcast ones on the
// unvectorised strided path (elementwise_kernel<128,4>): it reads and writes
// each activation three times where this kernel reads it once and writes it
// once.
//
// Input: x [B, C, H, W] in float32, bfloat16 or float16, contiguous NCHW or
// channels-last (NHWC in memory: the serving forward's layout); s [C] (batch
// norm) or [B, C] (the gate: a scale per image and channel) and t [C] or
// none, in x's type. act: 0 none, 1 SiLU (x / (1 + expf(-x)) in float32,
// PyTorch's formula), 2 ReLU (NaN kept, else fmaxf(x, 0), as clamp_min),
// 3 GELU, the erf form (x * 0.5 * (1 + erff(x * M_SQRT1_2)) in float32,
// left to right, as PyTorch's GeluCUDAKernelImpl writes it).
// Products and sums are formed in float32 from the typed operands and
// rounded to the type after each (__fmul_rn and __fadd_rn: no multiply-add
// is contracted across a rounding), as PyTorch's CUDA functors compute in
// float32 and store the type.
//
// What bounds it on the card: the bytes, 2 x numel x the type's size, at
// 3.35 TB/s; its work is a few operations an element (SiLU's expf and division,
// GELU's erff, the most). The design: each thread takes 16 bytes at a time
// (8 bfloat16 values) with one load and one store, in a grid-stride loop of
// one wave of blocks. In channels-last with C a multiple of 8 the 8 values
// are 8 channels of one pixel, and their coefficients are one 16-byte load
// each from the tables (a few KB, read through the L1 cache); in NCHW with
// H x W a multiple of 8 they share one channel and one coefficient. Other
// shapes take one element at a time.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNone = 0, kSilu = 1, kRelu = 2, kGelu = 3;
constexpr float kSqrtHalf = 0.70710678118654752440f;   // M_SQRT1_2 in float32

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half narrow<__half>(float v) { return __float2half(v); }

// v rounded to T and read back as float32
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return widen(narrow<T>(v));
}

template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

template <typename T, int ACT, bool SHIFT>
__device__ __forceinline__ T apply(T x, T s, T t) {
  float y = round_to<T>(__fmul_rn(widen(x), widen(s)));
  if (SHIFT) y = round_to<T>(__fadd_rn(y, widen(t)));
  if (ACT == kSilu) y = round_to<T>(y / (1.0f + expf(-y)));
  if (ACT == kRelu) y = isnan(y) ? y : fmaxf(y, 0.0f);
  if (ACT == kGelu)
    y = __fmul_rn(__fmul_rn(y, 0.5f), __fadd_rn(1.0f, erff(__fmul_rn(y, kSqrtHalf))));
  return narrow<T>(y);
}

// n_packs packs of V elements; scale index (b * s_image + c), shift index c.
template <typename T, int ACT, bool SHIFT, int V>
__global__ void __launch_bounds__(kThreads) bn_act_kernel(
    const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ shift,
    T* __restrict__ y, unsigned n_packs, unsigned C, unsigned HW, unsigned s_image,
    bool channels_last) {
  for (unsigned p = blockIdx.x * kThreads + threadIdx.x; p < n_packs; p += gridDim.x * kThreads) {
    const unsigned i = p * V;
    unsigned c, b;
    if (channels_last) {
      const unsigned pixel = i / C;
      c = i - pixel * C;
      b = pixel / HW;
    } else {
      const unsigned plane = i / HW;
      b = plane / C;
      c = plane - b * C;
    }
    const Pack<T, V> in = *reinterpret_cast<const Pack<T, V>*>(x + i);
    Pack<T, V> s, t, out;
    if (channels_last) {            // V consecutive channels of one pixel
      s = *reinterpret_cast<const Pack<T, V>*>(scale + b * s_image + c);
      if (SHIFT) t = *reinterpret_cast<const Pack<T, V>*>(shift + c);
    } else {                        // one channel
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s.v[k] = scale[b * s_image + c];
        if (SHIFT) t.v[k] = shift[c];
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) out.v[k] = apply<T, ACT, SHIFT>(in.v[k], s.v[k], SHIFT ? t.v[k] : s.v[k]);
    *reinterpret_cast<Pack<T, V>*>(y + i) = out;
  }
}

int blocks_for(unsigned n_packs) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const unsigned wave = (unsigned)sms * (2048 / kThreads);   // the blocks resident at once
  const unsigned need = (n_packs + kThreads - 1) / kThreads;
  return (int)(need < wave ? need : wave);
}

template <typename T, int ACT, bool SHIFT>
int launch(const void* x, const void* scale, const void* shift, void* y, unsigned n, unsigned C,
           unsigned HW, unsigned s_image, bool channels_last, bool packed, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (packed) {
    const unsigned n_packs = n / V;
    bn_act_kernel<T, ACT, SHIFT, V><<<blocks_for(n_packs), kThreads, 0, stream>>>(
        (const T*)x, (const T*)scale, (const T*)shift, (T*)y, n_packs, C, HW, s_image,
        channels_last);
  } else {
    bn_act_kernel<T, ACT, SHIFT, 1><<<blocks_for(n), kThreads, 0, stream>>>(
        (const T*)x, (const T*)scale, (const T*)shift, (T*)y, n, C, HW, s_image, channels_last);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* x, const void* scale, const void* shift, void* y, unsigned n,
                 unsigned C, unsigned HW, unsigned s_image, bool channels_last, bool packed,
                 int act, cudaStream_t stream) {
  if (shift == nullptr)   // the gate: a scale alone, no activation
    return act == kNone ? launch<T, kNone, false>(x, scale, shift, y, n, C, HW, s_image,
                                                  channels_last, packed, stream)
                        : (int)cudaErrorInvalidValue;
  switch (act) {
    case kNone: return launch<T, kNone, true>(x, scale, shift, y, n, C, HW, s_image,
                                              channels_last, packed, stream);
    case kSilu: return launch<T, kSilu, true>(x, scale, shift, y, n, C, HW, s_image,
                                              channels_last, packed, stream);
    case kRelu: return launch<T, kRelu, true>(x, scale, shift, y, n, C, HW, s_image,
                                              channels_last, packed, stream);
    case kGelu: return launch<T, kGelu, true>(x, scale, shift, y, n, C, HW, s_image,
                                              channels_last, packed, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). x and
// y hold n = B*C*HW elements of `dtype` (0 float32, 1 bfloat16, 2 float16)
// in one layout (channels_last 1: NHWC in memory, else NCHW); scale holds
// C values, or B*C with per_image 1; shift C values, or is null (then act
// must be 0). packed 1 takes 16 bytes at a time: every pointer 16-byte
// aligned and C (channels-last) or HW (NCHW) a multiple of 16 / the type's
// size. n < 2^31.
extern "C" int iseg_bn_act(const void* x, const void* scale, const void* shift, void* y,
                           long long n, int C, long long HW, int per_image, int channels_last,
                           int packed, int act, int dtype, void* stream) {
  if (n <= 0 || n >= (1ll << 31) || C < 1 || HW < 1) return (int)cudaErrorInvalidValue;
  const unsigned s_image = per_image ? (unsigned)C : 0u;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_typed<float>(x, scale, shift, y, (unsigned)n, (unsigned)C,
                                       (unsigned)HW, s_image, channels_last, packed, act, s);
    case 1: return launch_typed<__nv_bfloat16>(x, scale, shift, y, (unsigned)n, (unsigned)C,
                                               (unsigned)HW, s_image, channels_last, packed,
                                               act, s);
    case 2: return launch_typed<__half>(x, scale, shift, y, (unsigned)n, (unsigned)C,
                                        (unsigned)HW, s_image, channels_last, packed, act, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
