// Dropout for Hopper (sm_90a): the reference's mask, regenerated from its
// key in the kernel, applied in one pass.
//
// The reference has no Pallas kernel here: paddle_tpu/nn/functional.py
// `dropout` (:688) is XLA, `jnp.where(bernoulli(key, 1 - p, shape), a /
// (1 - p), 0)`, with the bits of jax.random under x64 and the
// partitionable threefry. This kernel gives the same output bit for bit:
//
//   (w1, w2) = threefry2x32((k1, k2), (hi(j), lo(j)))  j = the mask index
//   m        = ((w1 << 32 | w2) >> 12)                 52 bits
//   keep     = m < threshold                           threshold =
//              ceil((1 - p) * 2^52), so that keep == (m * 2^-52 < 1 - p),
//              the reference's float64 uniform compared in float64
//   y        = keep ? round_to_T(a / q) : 0            upscale_in_train
//   y        = keep ? a : 0                            downscale_in_infer
//
// q is 1 - p rounded to the activation's dtype (the reference divides by a
// weakly typed Python float, which takes a's dtype); for float32 and
// bfloat16 the division is IEEE float32 (__fdiv_rn: no fast-math) and a
// bfloat16 result is rounded once to nearest even; for float64 it is IEEE
// float64 (__ddiv_rn). The key words arrive as launch arguments: the host
// has folded the draw's counter into the base key.
// The backward launches the same kernel on dy: the mask is regenerated
// from the key, never stored, so a recomputed forward replays it too.
//
// The mask index j is the element's flat index; with a broadcast mask
// (`axis`), the flat index in the mask's own shape, from the output
// coordinates and the mask's strides (0 along a broadcast dimension).
//
// What bounds it on this card: integer instructions, not bytes. One hash
// is 2 key additions and 20 rounds of add, funnel-shift rotate and xor,
// with 5 key injections of 2 additions: 72 INT32 instructions, plus the
// 52-bit word, its compare and the index, about 80 an element. The card
// issues 64 INT32 operations an SM a clock, 132 SMs: at
// [8, 1024, 1024] (8.4 M elements) the hashes take about 0.04 ms, the
// bytes (one read, one write) 0.01-0.02 ms. So the design is one hash per
// thread per element, a grid-stride loop over the flat index with
// coalesced loads, and nothing else in the way of the integer pipes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_record.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDims = 8;

struct Broadcast {
  long long dims[kMaxDims];     // the output's shape, row-major
  long long mstride[kMaxDims];  // the mask's stride per dim, 0: broadcast
  int ndim;                     // 0: the mask is the output's shape
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r)     \
  x1 += x2;             \
  x2 = rotl(x2, r) ^ x1;

// threefry2x32, 20 rounds, as paddle_tpu_torch/random.py threefry2x32
__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2,
                                         uint32_t& x1, uint32_t& x2) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  x1 += k1;
  x2 += k2;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x1 += k2;
  x2 += k3 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x1 += k3;
  x2 += k1 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x1 += k1;
  x2 += k2 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x1 += k2;
  x2 += k3 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x1 += k3;
  x2 += k1 + 5u;
}

#undef TF_ROUND

// Each dtype's arithmetic type: float for float32 and bfloat16, double
// for float64.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float divide(float a, double q) {
  return __fdiv_rn(a, (float)q);  // q is a float32 or bfloat16 value
}
__device__ __forceinline__ double divide(double a, double q) {
  return __ddiv_rn(a, q);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(double* p, double v) { *p = v; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
               uint32_t k1, uint32_t k2, unsigned long long threshold,
               double q, int upscale, const Broadcast bc) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    long long j = i;
    if (bc.ndim > 0) {  // the mask index of a broadcast mask
      long long rem = i;
      j = 0;
      for (int d = bc.ndim - 1; d >= 0; --d) {
        const long long c = rem % bc.dims[d];
        rem /= bc.dims[d];
        j += c * bc.mstride[d];
      }
    }
    uint32_t w1 = (uint32_t)((unsigned long long)j >> 32);
    uint32_t w2 = (uint32_t)j;
    threefry(k1, k2, w1, w2);
    const unsigned long long m =
        ((unsigned long long)w1 << 20) | (unsigned long long)(w2 >> 12);
    decltype(widen(x[i])) out = 0;
    if (m < threshold) {
      const auto a = widen(x[i]);
      out = upscale ? divide(a, q) : a;
    }
    store(y + i, out);
  }
}

}  // namespace

// C entry point, loaded with ctypes. y = dropout(x) over n elements of
// dtype (0 float32, 1 bfloat16, 2 float64), contiguous; x and y may be the
// same buffer. (k1, k2): the draw's key words; threshold: ceil((1 - p) * 2^52);
// q: 1 - p rounded to the dtype; upscale: 1 for upscale_in_train (divide
// kept values by q), 0 for downscale_in_infer (keep them as they are).
// ndim > 0: the mask broadcasts, dims[ndim] is the output's shape and
// mstrides[ndim] the mask's element strides (0 along a broadcast
// dimension); ndim = 0: the mask index is the flat index. Launches on
// `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int dropout(const void* x, void* y, long long n, int dtype,
                       unsigned int k1, unsigned int k2,
                       unsigned long long threshold, double q, int upscale,
                       int ndim, const long long* dims,
                       const long long* mstrides, void* stream) {
  if (n <= 0 || dtype < 0 || dtype > 2 || ndim < 0 || ndim > kMaxDims)
    return (int)cudaErrorInvalidValue;
  Broadcast bc{};
  bc.ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    if (dims[d] <= 0 || mstrides[d] < 0) return (int)cudaErrorInvalidValue;
    bc.dims[d] = dims[d];
    bc.mstride[d] = mstrides[d];
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (launch_record::note(dim3(blocks), kThreads, 0)) return (int)cudaSuccess;
  if (dtype == 0)
    dropout_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, k1, k2,
        threshold, q, upscale, bc);
  else if (dtype == 1)
    dropout_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        n, k1, k2, threshold, q, upscale, bc);
  else
    dropout_kernel<double><<<blocks, kThreads, 0, st>>>(
        static_cast<const double*>(x), static_cast<double*>(y), n, k1, k2,
        threshold, q, upscale, bc);
  return (int)cudaGetLastError();
}

// The launch of dropout over n elements (ndim = 0), without making it (see
// launch_record.cuh). Returns the launch count, or the entry point's error
// negated.
extern "C" int dropout_geometry(long long n, int dtype, int* out, int max) {
  void* p = launch_record::fake_ptr();
  launch_record::Scope scope(out, max);
  const int err = dropout(p, p, n, dtype, 0u, 0u, 0ull, 1.0, 1, 0, nullptr,
                          nullptr, nullptr);
  return launch_record::result(scope, err);
}
