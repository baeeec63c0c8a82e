// Fused Adam / AdamW update for Hopper (sm_90a), every tensor of an
// optimizer step in one launch.
//
// Replaces paddle_tpu/kernels/fused_optimizer.py::_adam_kernel (launched
// by fused_adam_update(), pallas_call at :73). In place over flat float32
// buffers p (the parameter or its float32 master), m and v of any length,
// for each tensor of the step:
//
//   p  = p * decay                          (AdamW's decoupled decay; 1 = off)
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*g^2
//   p' = p - lr*(m'/bc1) / (sqrt(v'/bc2) + eps)
//
// g is float32 or bfloat16 (converted in registers); when the parameter
// itself is bfloat16 the kernel also writes its copy of p' (round to
// nearest even) in the same pass.
//
// What bounds it on this card: bytes. Each element is read and written
// once (p, m, v in float32, g and the bf16 copy in two bytes): 28 bytes
// per element at 3.35 TB/s, for 10 operations. One launch per tensor
// (a training step has 292, two thirds of them biases and LayerNorm
// weights of at most 4,096 elements) left the card ramping up and
// draining for each; so one launch walks every tensor of the step:
// - the tensors are cut into chunks of kChunk elements (a multiple of 4,
//   so every chunk starts 16-byte aligned); a persistent grid of a few
//   blocks an SM strides over the chunk index, and a block finds its
//   chunk's tensor by binary search over the per-tensor first chunks;
// - the per-tensor table (pointers, n, decay, the g dtype, first chunk)
//   is a kernel parameter (__grid_constant__), so a step copies nothing
//   to the device and allocates nothing. Toolkits from CUDA 12.1 take
//   32,764 bytes of parameters, room for kCapacity = 545 tensors (one
//   launch a step); older ones 4,096 bytes, 67 tensors, and the caller's
//   plan then splits the list (at most 5 launches for 292 tensors);
// - each thread keeps kUnroll 16-byte groups in flight per step, and the
//   last n % 4 elements of a tensor take a scalar tail.
//
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, ...: no
// fused multiply-add contraction) in the plain version's order, so the
// result equals the plain PyTorch version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float lr, bc1, bc2, decay, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ float load_g(const float* g, size_t i) {
  return g[i];
}
__device__ __forceinline__ float load_g(const __nv_bfloat16* g, size_t i) {
  return __bfloat162float(g[i]);
}

__device__ __forceinline__ void load_g4(const float* g, size_t i,
                                        float (&out)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(g + i);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void load_g4(const __nv_bfloat16* g, size_t i,
                                        float (&out)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(g + i);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

// one element, in the plain version's order of operations
__device__ __forceinline__ void adam(float& p, float& m, float& v, float g,
                                     const Hyper& hp) {
  p = __fmul_rn(p, hp.decay);
  m = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.omb1, g));
  v = __fadd_rn(__fmul_rn(hp.b2, v), __fmul_rn(hp.omb2, __fmul_rn(g, g)));
  const float m_hat = __fdiv_rn(m, hp.bc1);
  const float v_hat = __fdiv_rn(v, hp.bc2);
  const float den = __fadd_rn(__fsqrt_rn(v_hat), hp.eps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(hp.lr, m_hat), den));
}

// one tensor of the step
struct Entry {
  float* p;
  const void* g;
  float* m;
  float* v;
  __nv_bfloat16* p_bf16;  // or null
  long long n;
  float decay;
  int g_bf16;  // 0: g is float32, 1: bfloat16
};

#if CUDART_VERSION >= 12010
constexpr int kParamBytes = 32764;  // kernel parameters, CUDA 12.1 and later
#else
constexpr int kParamBytes = 4096;
#endif
constexpr int kUnroll = 2;                       // 16-byte groups in flight
constexpr int kChunk = 4 * kThreads * kUnroll * 8;  // elements, 16,384
constexpr int kBlocksPerSm = 4;
// the table's bytes: 56 a tensor and its first chunk (4); the chunk
// total, the count and alignment (16) and the hyperparameters (36)
constexpr int kEntryBytes = sizeof(Entry) + 4;
constexpr int kFixedBytes = sizeof(Hyper) + 16;
constexpr int kCapacity = (kParamBytes - kFixedBytes) / kEntryBytes;

struct Table {
  Entry e[kCapacity];
  int first_chunk[kCapacity + 1];  // first_chunk[count] = the chunk total
  int count;
};
static_assert(sizeof(Entry) == 56, "the wrapper's plan counts 56 bytes");
static_assert(sizeof(Table) + sizeof(Hyper) <= kParamBytes,
              "the table must fit the kernel parameters");

template <typename G>
__device__ __forceinline__ void adam_chunk(const Entry& e, long long begin,
                                           long long end, const Hyper& hp) {
  float* __restrict__ p = e.p;
  float* __restrict__ m = e.m;
  float* __restrict__ v = e.v;
  const G* __restrict__ g = static_cast<const G*>(e.g);
  __nv_bfloat16* __restrict__ p_bf16 = e.p_bf16;
  const long long vec_end = begin + ((end - begin) & ~3ll);
  for (long long base = begin + 4 * threadIdx.x; base < vec_end;
       base += 4 * kThreads * kUnroll) {
    float4 p4[kUnroll], m4[kUnroll], v4[kUnroll];
    float gg[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load first, then the math
      const long long i = base + 4 * kThreads * u;
      if (i < vec_end) {
        p4[u] = *reinterpret_cast<const float4*>(p + i);
        m4[u] = *reinterpret_cast<const float4*>(m + i);
        v4[u] = *reinterpret_cast<const float4*>(v + i);
        load_g4(g, i, gg[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + 4 * kThreads * u;
      if (i >= vec_end) continue;
      adam(p4[u].x, m4[u].x, v4[u].x, gg[u][0], hp);
      adam(p4[u].y, m4[u].y, v4[u].y, gg[u][1], hp);
      adam(p4[u].z, m4[u].z, v4[u].z, gg[u][2], hp);
      adam(p4[u].w, m4[u].w, v4[u].w, gg[u][3], hp);
      *reinterpret_cast<float4*>(p + i) = p4[u];
      *reinterpret_cast<float4*>(m + i) = m4[u];
      *reinterpret_cast<float4*>(v + i) = v4[u];
      if (p_bf16 != nullptr) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(p4[u].x, p4[u].y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(p4[u].z, p4[u].w);
        uint2 out;
        out.x = *reinterpret_cast<uint32_t*>(&lo);
        out.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(p_bf16 + i) = out;
      }
    }
  }
  // the tail: the tensor's last n % 4 elements, one thread each
  const long long t = vec_end + threadIdx.x;
  if (t < end) {
    float pp = p[t], mm = m[t], vv = v[t];
    adam(pp, mm, vv, load_g(g, t), hp);
    p[t] = pp;
    m[t] = mm;
    v[t] = vv;
    if (p_bf16 != nullptr) p_bf16[t] = __float2bfloat16(pp);
  }
}

__global__ void __launch_bounds__(kThreads)
fused_adam_multi_kernel(const __grid_constant__ Table tab, Hyper hp) {
  const int total = tab.first_chunk[tab.count];
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    // the last tensor whose first chunk is at most c
    int lo = 0, hi = tab.count - 1;
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
    Hyper h = hp;
    h.decay = e.decay;
    if (e.g_bf16)
      adam_chunk<__nv_bfloat16>(e, begin, end, h);
    else
      adam_chunk<float>(e, begin, end, h);
  }
}

}  // namespace

// The kernel-parameter bytes and the chunk size this library was built
// with, for the caller's launch plan.
extern "C" int fused_adam_param_bytes() { return kParamBytes; }
extern "C" int fused_adam_chunk() { return kChunk; }

// C entry point, loaded with ctypes: one Adam step for `count` tensors in
// n_launches launches; launch j updates tensors bounds[j] .. bounds[j+1]
// - 1 (the caller's plan: bounds[0] = 0, bounds[n_launches] = count, at
// most kCapacity tensors a launch). Tensor i: p[i], m[i], v[i]
// float32, updated in place; g[i] float32 (g_dtype[i] = 0) or bfloat16
// (1); p_bf16[i] (or null) receives p' rounded to bfloat16; n[i] > 0
// elements; decay[i] its decay factor. Every pointer 16-byte aligned.
// beta, 1 - beta and eps arrive as float32 values already rounded by the
// caller. Launches on `stream`, does not synchronise, allocates nothing,
// and returns the first error of cudaGetLastError() after a launch (0 =
// success).
extern "C" int fused_adam(int count, void* const* p, const void* const* g,
                          void* const* m, void* const* v,
                          void* const* p_bf16, const long long* n,
                          const int* g_dtype, const float* decay,
                          const int* bounds, int n_launches, float lr,
                          float bc1, float bc2, float b1, float omb1,
                          float b2, float omb2, float eps, void* stream) {
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
  const Hyper hp{lr, bc1, bc2, 1.f, b1, omb1, b2, omb2, eps};
  static Table tab;  // host staging of the parameter; ctypes calls drop
  static std::mutex mutex;  // the interpreter lock
  std::lock_guard<std::mutex> lock(mutex);
  for (int j = 0; j < n_launches; ++j) {
    const int first = bounds[j], last = bounds[j + 1];
    if (last <= first || last - first > kCapacity)
      return (int)cudaErrorInvalidValue;
    long long chunks = 0;
    tab.count = last - first;
    for (int i = first; i < last; ++i) {
      if (n[i] <= 0 || (g_dtype[i] != 0 && g_dtype[i] != 1))
        return (int)cudaErrorInvalidValue;
      Entry& e = tab.e[i - first];
      e = Entry{static_cast<float*>(p[i]), g[i], static_cast<float*>(m[i]),
                static_cast<float*>(v[i]),
                static_cast<__nv_bfloat16*>(p_bf16[i]), n[i], decay[i],
                g_dtype[i]};
      tab.first_chunk[i - first] = (int)chunks;
      chunks += (n[i] + kChunk - 1) / kChunk;
      if (chunks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
    }
    tab.first_chunk[tab.count] = (int)chunks;
    const long long blocks =
        chunks < (long long)sms * kBlocksPerSm ? chunks
                                               : (long long)sms * kBlocksPerSm;
    fused_adam_multi_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(tab, hp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
