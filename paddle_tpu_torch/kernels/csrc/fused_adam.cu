// Fused Adam / AdamW update for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/fused_optimizer.py::_adam_kernel (launched
// by fused_adam_update(), pallas_call at :73). In place over one flat
// float32 buffer each of p (the parameter or its float32 master), m and
// v, of any length:
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
// per element at 3.35 TB/s, for 10 operations. The TPU kernel needed its
// buffers padded to whole (8, 1024) tiles and its caller skipped sizes
// that were not; here a grid-stride loop walks 4 elements per thread per
// step with 16-byte loads and stores, and the last n % 4 elements take a
// scalar tail, so any length runs with no padding copy.
//
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, ...: no
// fused multiply-add contraction) in the plain version's order, so the
// result equals the plain PyTorch version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename G>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(float* __restrict__ p, const G* __restrict__ g,
                  float* __restrict__ m, float* __restrict__ v,
                  __nv_bfloat16* __restrict__ p_bf16, size_t n, Hyper hp) {
  const size_t n4 = n / 4;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const size_t e = 4 * i;
    float4 p4 = *reinterpret_cast<float4*>(p + e);
    float4 m4 = *reinterpret_cast<float4*>(m + e);
    float4 v4 = *reinterpret_cast<float4*>(v + e);
    float gg[4];
    load_g4(g, e, gg);
    adam(p4.x, m4.x, v4.x, gg[0], hp);
    adam(p4.y, m4.y, v4.y, gg[1], hp);
    adam(p4.z, m4.z, v4.z, gg[2], hp);
    adam(p4.w, m4.w, v4.w, gg[3], hp);
    *reinterpret_cast<float4*>(p + e) = p4;
    *reinterpret_cast<float4*>(m + e) = m4;
    *reinterpret_cast<float4*>(v + e) = v4;
    if (p_bf16 != nullptr) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(p4.x, p4.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(p4.z, p4.w);
      uint2 out;
      out.x = *reinterpret_cast<uint32_t*>(&lo);
      out.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(p_bf16 + e) = out;
    }
  }
  // the tail: the last n % 4 elements, one thread each
  const size_t t = 4 * n4 + (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) {
    float pp = p[t], mm = m[t], vv = v[t];
    adam(pp, mm, vv, load_g(g, t), hp);
    p[t] = pp;
    m[t] = mm;
    v[t] = vv;
    if (p_bf16 != nullptr) p_bf16[t] = __float2bfloat16(pp);
  }
}

template <typename G>
cudaError_t launch(float* p, const G* g, float* m, float* v,
                   __nv_bfloat16* p_bf16, size_t n, const Hyper& hp,
                   cudaStream_t stream) {
  // enough blocks to fill the card several times over; the loop strides
  size_t blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks == 0) blocks = 1;
  fused_adam_kernel<G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      p, g, m, v, p_bf16, n, hp);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes: one launch per tensor, `count`
// tensors from one call (a training step updates a few hundred, and one
// Python call per launch would leave the card waiting on the host).
// Tensor i: p[i], m[i], v[i] float32, updated in place; g[i] float32
// (g_dtype[i] = 0) or bfloat16 (1); p_bf16[i] (or null) receives p'
// rounded to bfloat16; n[i] elements; decay[i] its decay factor. Every
// pointer 16-byte aligned. beta, 1 - beta and eps arrive as float32
// values already rounded by the caller. Launches on `stream`, does not
// synchronise, allocates nothing, and returns the first error of
// cudaGetLastError() after a launch (0 = success).
extern "C" int fused_adam(int count, void* const* p, const void* const* g,
                          void* const* m, void* const* v,
                          void* const* p_bf16, const long long* n,
                          const int* g_dtype, const float* decay, float lr,
                          float bc1, float bc2, float b1, float omb1,
                          float b2, float omb2, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0) return (int)cudaErrorInvalidValue;
    const Hyper hp{lr, bc1, bc2, decay[i], b1, omb1, b2, omb2, eps};
    float* pi = static_cast<float*>(p[i]);
    float* mi = static_cast<float*>(m[i]);
    float* vi = static_cast<float*>(v[i]);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p_bf16[i]);
    cudaError_t err;
    if (g_dtype[i] == 0)
      err = launch(pi, static_cast<const float*>(g[i]), mi, vi, out,
                   (size_t)n[i], hp, st);
    else if (g_dtype[i] == 1)
      err = launch(pi, static_cast<const __nv_bfloat16*>(g[i]), mi, vi, out,
                   (size_t)n[i], hp, st);
    else
      return (int)cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
