// Global gradient norm and clip scale for Hopper (sm_90a), every gradient
// of an optimizer step in one multi-tensor launch.
//
// The reference has no Pallas kernel here: paddle_tpu/utils/clip_grad.py
// ClipGradByGlobalNorm.apply (:60) is XLA,
//
//   total = sum over tensors of sum(float32(g)^2)
//   scale = min(1, clip / (sqrt(total) + 1e-6))          float32
//
// and the optimizer then updates from (g * scale) rounded to g's dtype,
// which the fused Adam kernel forms in its own pass (csrc/fused_adam.cu
// reads `scale` from the device). So the step never reads the norm back
// to the host and never writes a clipped gradient.
//
// Two launches (more only where the toolkit's 4 KB parameter limit splits
// the table of tensors):
// - sumsq: each tensor is cut into chunks of kChunk elements; a
//   persistent grid strides over the chunk index, a block finds its
//   chunk's tensor by binary search over the per-tensor first chunks (the
//   table is a __grid_constant__ kernel parameter: nothing is copied to
//   the device), squares and sums its chunk in float32 (16-byte loads,
//   each thread its own sum, then a fixed tree over the block) and writes
//   the chunk's partial sum to partials[chunk];
// - finalize: one block sums the partials in a fixed order in float64,
//   rounds the total to float32, and writes {total, scale} with IEEE
//   square root and division (__fsqrt_rn, __fdiv_rn: no fast-math), NaN
//   passed on as jnp.minimum passes it.
// The result is the same run to run. Its summation order is not XLA's
// per-tensor jnp.sum: it agrees with the plain version within float32
// rounding of the norm.
//
// What bounds it on this card: bytes. Each gradient element is read once
// (2 bytes in bf16) for 2 operations; at the training step's 354,871,296
// bf16 gradients that is 0.71 GB, 0.21 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "launch_record.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFinalThreads = 1024;
constexpr int kUnroll = 4;                          // 16-byte loads in flight
constexpr int kChunk = 4 * kThreads * kUnroll * 4;  // elements, 16,384
constexpr int kBlocksPerSm = 4;

struct Entry {
  const void* g;
  long long n;
  int bf16;  // 0: float32, 1: bfloat16
  int pad;
};

#if CUDART_VERSION >= 12010
constexpr int kParamBytes = 32764;  // kernel parameters, CUDA 12.1 and later
#else
constexpr int kParamBytes = 4096;
#endif
// a tensor's entry and its first chunk; the count, the partial offset and
// alignment
constexpr int kEntryBytes = sizeof(Entry) + 4;
constexpr int kFixedBytes = 16;
constexpr int kCapacity = (kParamBytes - kFixedBytes) / kEntryBytes;

struct Table {
  Entry e[kCapacity];
  int first_chunk[kCapacity + 1];  // first_chunk[count] = the chunk total
  int count;
  int partial_offset;  // the first chunk's slot in partials
};
static_assert(sizeof(Entry) == 24, "the wrapper's plan counts 24 bytes");
static_assert(sizeof(Table) <= kParamBytes,
              "the table must fit the kernel parameters");

__device__ __forceinline__ float sq4(const float* g, long long i) {
  const float4 x = *reinterpret_cast<const float4*>(g + i);
  return x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
}
__device__ __forceinline__ float sq4(const __nv_bfloat16* g, long long i) {
  const uint2 raw = *reinterpret_cast<const uint2*>(g + i);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return a.x * a.x + a.y * a.y + b.x * b.x + b.y * b.y;
}
__device__ __forceinline__ float sq1(const float* g, long long i) {
  return g[i] * g[i];
}
__device__ __forceinline__ float sq1(const __nv_bfloat16* g, long long i) {
  const float x = __bfloat162float(g[i]);
  return x * x;
}

template <typename G>
__device__ __forceinline__ float chunk_sumsq(const G* __restrict__ g,
                                             long long begin, long long end) {
  float acc = 0.f;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(g + begin) & (4 * sizeof(G) - 1)) == 0;
  long long vec_end = aligned ? begin + ((end - begin) & ~3ll) : begin;
  for (long long base = begin + 4 * threadIdx.x; base < vec_end;
       base += 4 * kThreads * kUnroll) {
    float part[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + 4 * kThreads * u;
      part[u] = i < vec_end ? sq4(g, i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += part[u];
  }
  for (long long t = vec_end + threadIdx.x; t < end; t += kThreads)
    acc += sq1(g, t);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const __grid_constant__ Table tab, float* __restrict__ partials) {
  __shared__ float warp_sums[kThreads / 32];
  const int total = tab.first_chunk[tab.count];
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    int lo = 0, hi = tab.count - 1;  // the last tensor starting at or before c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tab.first_chunk[mid] <= c)
        lo = mid;
      else
        hi = mid - 1;
    }
    const Entry& e = tab.e[lo];
    const long long begin = (long long)(c - tab.first_chunk[lo]) * kChunk;
    const long long end = begin + kChunk < e.n ? begin + kChunk : e.n;
    float acc = e.bf16 ? chunk_sumsq(static_cast<const __nv_bfloat16*>(e.g),
                                     begin, end)
                       : chunk_sumsq(static_cast<const float*>(e.g), begin,
                                     end);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
      partials[tab.partial_offset + c] = s;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kFinalThreads)
finalize_kernel(const float* __restrict__ partials, int n, float clip,
                float* __restrict__ out) {
  __shared__ double sums[kFinalThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kFinalThreads) acc += partials[i];
  sums[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kFinalThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) sums[threadIdx.x] += sums[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float total = (float)sums[0];
    const float norm = __fsqrt_rn(total);
    const float ratio = __fdiv_rn(clip, __fadd_rn(norm, 1e-6f));
    out[0] = total;
    out[1] = ratio > 1.f ? 1.f : ratio;  // NaN passes, as jnp.minimum
  }
}

}  // namespace

// The kernel-parameter bytes and chunk size this library was built with,
// for the caller's launch plan.
extern "C" int global_norm_param_bytes() { return kParamBytes; }
extern "C" int global_norm_chunk() { return kChunk; }

// C entry point, loaded with ctypes: the sums of squares of `count`
// gradients g[i] (n[i] > 0 elements each; dtype[i] 0 float32, 1 bfloat16)
// into partials[0 .. n_partials), one float32 partial a chunk of kChunk
// elements, in tensor order: n_launches sumsq launches, launch j over
// tensors bounds[j] .. bounds[j+1] - 1 (the caller's plan). On `stream`,
// no synchronisation, no allocation; returns the first cudaGetLastError()
// after a launch (0 = success). Between this and global_norm_finish the
// caller may reduce the partials over ranks (a hybrid-parallel norm).
extern "C" int global_norm_sums(int count, const void* const* g,
                                const long long* n, const int* dtype,
                                const int* bounds, int n_launches,
                                float* partials, int n_partials,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (count <= 0 || n_launches <= 0 || bounds[0] != 0 ||
      bounds[n_launches] != count)
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  static Table tab;         // host staging of the parameter; ctypes calls
  static std::mutex mutex;  // drop the interpreter lock
  std::lock_guard<std::mutex> lock(mutex);
  long long offset = 0;
  for (int j = 0; j < n_launches; ++j) {
    const int first = bounds[j], last = bounds[j + 1];
    if (last <= first || last - first > kCapacity)
      return (int)cudaErrorInvalidValue;
    long long chunks = 0;
    tab.count = last - first;
    tab.partial_offset = (int)offset;
    for (int i = first; i < last; ++i) {
      if (n[i] <= 0 || (dtype[i] != 0 && dtype[i] != 1))
        return (int)cudaErrorInvalidValue;
      tab.e[i - first] = Entry{g[i], n[i], dtype[i], 0};
      tab.first_chunk[i - first] = (int)chunks;
      chunks += (n[i] + kChunk - 1) / kChunk;
    }
    if (offset + chunks > n_partials) return (int)cudaErrorInvalidValue;
    tab.first_chunk[tab.count] = (int)chunks;
    const long long cap = (long long)sms * kBlocksPerSm;
    const unsigned blocks = (unsigned)(chunks < cap ? chunks : cap);
    if (!launch_record::note(dim3(blocks), kThreads, 0)) {
      sumsq_kernel<<<blocks, kThreads, 0, st>>>(tab, partials);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    offset += chunks;
  }
  if (offset != n_partials) return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// C entry point: one launch that sums partials[0 .. n_partials) in float64
// and writes out[0] = the float32 total, out[1] = min(1, clip /
// (sqrt(out[0]) + 1e-6)). On `stream`; returns cudaGetLastError().
extern "C" int global_norm_finish(const float* partials, int n_partials,
                                  float clip, float* out, void* stream) {
  if (n_partials <= 0) return (int)cudaErrorInvalidValue;
  if (launch_record::note(dim3(1), kFinalThreads, 0)) return (int)cudaSuccess;
  finalize_kernel<<<1, kFinalThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, n_partials, clip, out);
  return (int)cudaGetLastError();
}

// C entry point, loaded with ctypes: out[0] = the float32 sum of squares
// of the gradients, out[1] = min(1, clip / (sqrt(out[0]) + 1e-6)): the
// launches of global_norm_sums, then global_norm_finish's. partials:
// float32 scratch of n_partials = the total chunk count, written before
// it is read. On `stream`, no synchronisation, no allocation; returns the
// first cudaGetLastError() after a launch (0 = success).
extern "C" int global_norm(int count, const void* const* g,
                           const long long* n, const int* dtype,
                           const int* bounds, int n_launches, float* partials,
                           int n_partials, float clip, float* out,
                           void* stream) {
  const int err = global_norm_sums(count, g, n, dtype, bounds, n_launches,
                                   partials, n_partials, stream);
  if (err != (int)cudaSuccess) return err;
  return global_norm_finish(partials, n_partials, clip, out, stream);
}

constexpr int kQueryMax = 1 << 16;  // tensors a geometry query takes

// The launches of global_norm for `count` gradients of n[i] elements in the
// caller's plan (bounds, n_launches; n_partials their chunks), without
// making them (see launch_record.cuh). Returns the launch count, or the
// entry point's error negated.
extern "C" int global_norm_geometry(int count, const long long* n,
                                    const int* bounds, int n_launches,
                                    int n_partials, int* out, int max) {
  if (count <= 0 || count > kQueryMax) return -(int)cudaErrorInvalidValue;
  void* p = launch_record::fake_ptr();
  static const void* ptrs[kQueryMax];
  static int zeros[kQueryMax];
  for (int i = 0; i < count; ++i) ptrs[i] = p;
  launch_record::Scope scope(out, max);
  const int err = global_norm(count, ptrs, n, zeros, bounds, n_launches,
                              static_cast<float*>(p), n_partials, 1.f,
                              static_cast<float*>(p), nullptr);
  return launch_record::result(scope, err);
}
