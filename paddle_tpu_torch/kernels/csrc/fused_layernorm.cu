// Fused LayerNorm forward and input gradient for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/fused_layernorm.py::_ln_fwd_kernel (launched
// by _call_fwd, pallas_call at :69) and ::_ln_dx_kernel (launched by
// _call_dx, pallas_call at :93). Over rows of x [rows, d]:
//
//   forward  mu = mean(x); var = mean((x - mu)^2); rstd = 1 / sqrt(var + eps)
//            y = (x - mu) * rstd * gamma + beta        (y in x's dtype)
//   dx       xhat = (x - mu) * rstd; wdy = dy * gamma
//            dx = rstd * (wdy - mean(wdy) - xhat * mean(wdy * xhat))
//
// all in float32; mu and rstd are written as float32 [rows]. dgamma and
// dbeta reduce over rows and stay with PyTorch, as the reference leaves
// them to XLA.
//
// What bounds it on this card: bytes. Each element takes about ten
// operations against 4 to 6 bytes moved (x read and y written; x and dy
// read and dx written), far below the card's 295 operations per byte.
//
// What the design does about it:
// - one warp owns a row, eight rows to a block: the row's sums are warp
//   shuffles, with no shared memory and no block barrier;
// - lanes walk the row 16 bytes at a time (4 float32 or 8 bf16 values,
//   neighbouring lanes on neighbouring addresses) when d and every pointer
//   allow it, element by element otherwise, so any d runs, including
//   d < 32 * 8 and d not a multiple of the vector width;
// - the row is read from device memory once; the two-pass mean and
//   variance (the reference's order, :34-35) and the output pass re-read
//   it from L1/L2 instead of holding it in registers, so d is not bounded
//   by the register file (the wrapper states a maximum of 65,536).
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, ...: no
// fused multiply-add contraction) in the reference's order; only the
// order of the row sums differs from the plain version.
//
// Layouts (all contiguous): x, y, dy, dx [rows, d] float32 or bfloat16;
// gamma, beta [d] float32 or bfloat16 (one dtype for both); mu, rstd
// [rows] float32. Launch: grid ceil(rows / 8), 256 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kWarps = 8;  // rows per block, one warp each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// 16 bytes of U as floats
__device__ __forceinline__ void unpack16(uint4 raw, float* out, float) {
  const float4 v = *reinterpret_cast<const float4*>(&raw);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void unpack16(uint4 raw, float* out,
                                         __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack16(const float* v, float) {
  const float4 f = make_float4(v[0], v[1], v[2], v[3]);
  return *reinterpret_cast<const uint4*>(&f);
}
__device__ __forceinline__ uint4 pack16(const float* v, __nv_bfloat16) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return raw;
}

// N consecutive elements of U at p as floats: 16-byte loads where N fills
// whole 16-byte pieces (the caller guarantees the alignment), else one by
// one
template <int N, typename U>
__device__ __forceinline__ void load_n(const U* p, float (&out)[N]) {
  constexpr int kPer = 16 / sizeof(U);
  if constexpr (N % kPer == 0) {
#pragma unroll
    for (int c = 0; c < N / kPer; ++c)
      unpack16(__ldg(reinterpret_cast<const uint4*>(p) + c), out + c * kPer,
               U());
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

template <int N, typename U>
__device__ __forceinline__ void store_n(U* p, const float (&v)[N]) {
  constexpr int kPer = 16 / sizeof(U);
  if constexpr (N % kPer == 0) {
#pragma unroll
    for (int c = 0; c < N / kPer; ++c)
      reinterpret_cast<uint4*>(p)[c] = pack16(v + c * kPer, U());
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f32<U>(v[i]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
              const W* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ mu_out, float* __restrict__ rstd_out,
              int rows, int d, float eps) {
  // elements per lane per step: 16 bytes of T in the vector mode, else 1
  constexpr int N = kVec ? 16 / (int)sizeof(T) : 1;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: rows are warp-uniform
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;
  const float fd = (float)d;

  float sum = 0.f;
  for (int e = lane * N; e < d; e += 32 * N) {
    float v[N];
    load_n<N>(xr + e, v);
#pragma unroll
    for (int i = 0; i < N; ++i) sum = __fadd_rn(sum, v[i]);
  }
  const float mu = __fdiv_rn(warp_sum(sum), fd);

  float sq = 0.f;
  for (int e = lane * N; e < d; e += 32 * N) {
    float v[N];
    load_n<N>(xr + e, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float c = __fsub_rn(v[i], mu);
      sq = __fadd_rn(sq, __fmul_rn(c, c));
    }
  }
  const float var = __fdiv_rn(warp_sum(sq), fd);
  const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));

  for (int e = lane * N; e < d; e += 32 * N) {
    float v[N], g[N], b[N];
    load_n<N>(xr + e, v);
    load_n<N>(gamma + e, g);
    load_n<N>(beta + e, b);
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(v[i], mu), rstd), g[i]), b[i]);
    store_n<N>(yr + e, v);
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
ln_dx_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
             const float* __restrict__ mu_in,
             const float* __restrict__ rstd_in, const T* __restrict__ dy,
             T* __restrict__ dx, int rows, int d) {
  // elements per lane per step: 16 bytes of T in the vector mode, else 1
  constexpr int N = kVec ? 16 / (int)sizeof(T) : 1;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t off = (size_t)row * d;
  const float mu = mu_in[row];
  const float rstd = rstd_in[row];
  const float fd = (float)d;

  float s_wdy = 0.f, s_wdy_xhat = 0.f;
  for (int e = lane * N; e < d; e += 32 * N) {
    float v[N], g[N], t[N];
    load_n<N>(x + off + e, v);
    load_n<N>(gamma + e, g);
    load_n<N>(dy + off + e, t);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float xhat = __fmul_rn(__fsub_rn(v[i], mu), rstd);
      const float wdy = __fmul_rn(t[i], g[i]);
      s_wdy = __fadd_rn(s_wdy, wdy);
      s_wdy_xhat = __fadd_rn(s_wdy_xhat, __fmul_rn(wdy, xhat));
    }
  }
  const float c1 = __fdiv_rn(warp_sum(s_wdy), fd);
  const float c2 = __fdiv_rn(warp_sum(s_wdy_xhat), fd);

  for (int e = lane * N; e < d; e += 32 * N) {
    float v[N], g[N], t[N];
    load_n<N>(x + off + e, v);
    load_n<N>(gamma + e, g);
    load_n<N>(dy + off + e, t);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float xhat = __fmul_rn(__fsub_rn(v[i], mu), rstd);
      const float wdy = __fmul_rn(t[i], g[i]);
      v[i] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(wdy, c1),
                                       __fmul_rn(xhat, c2)));
    }
    store_n<N>(dx + off + e, v);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// the vector mode needs d a multiple of the vector width and every row
// and vector pointer on a 16-byte boundary
template <typename T>
bool vector_mode(int d, std::initializer_list<const void*> ptrs) {
  if (d % (16 / (int)sizeof(T))) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

template <typename T, typename W>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* beta,
                       void* y, void* mu, void* rstd, int rows, int d,
                       float eps, cudaStream_t stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const bool vec = vector_mode<T>(d, {x, gamma, beta, y});
  auto kernel = vec ? ln_fwd_kernel<T, W, true> : ln_fwd_kernel<T, W, false>;
  kernel<<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(gamma),
      static_cast<const W*>(beta), static_cast<T*>(y),
      static_cast<float*>(mu), static_cast<float*>(rstd), rows, d, eps);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_dx(const void* x, const void* gamma, const void* mu,
                      const void* rstd, const void* dy, void* dx, int rows,
                      int d, cudaStream_t stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const bool vec = vector_mode<T>(d, {x, gamma, dy, dx});
  auto kernel = vec ? ln_dx_kernel<T, W, true> : ln_dx_kernel<T, W, false>;
  kernel<<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(gamma),
      static_cast<const float*>(mu), static_cast<const float*>(rstd),
      static_cast<const T*>(dy), static_cast<T*>(dx), rows, d);
  return cudaGetLastError();
}

}  // namespace

// C entry points, loaded with ctypes. Dtype codes: 0 = float32,
// 1 = bfloat16 (x_dtype for x/y/dy/dx, w_dtype for gamma/beta). Each
// launches on `stream`, does not synchronise, allocates nothing, and
// returns cudaGetLastError() after the launch (0 = success).
extern "C" int ln_forward(const void* x, const void* gamma, const void* beta,
                          void* y, void* mu, void* rstd, int rows, int d,
                          float eps, int x_dtype, int w_dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
#define LN_FWD(T, W) \
  return (int)launch_fwd<T, W>(x, gamma, beta, y, mu, rstd, rows, d, eps, st)
  if (x_dtype == 0 && w_dtype == 0) LN_FWD(float, float);
  if (x_dtype == 0 && w_dtype == 1) LN_FWD(float, __nv_bfloat16);
  if (x_dtype == 1 && w_dtype == 0) LN_FWD(__nv_bfloat16, float);
  if (x_dtype == 1 && w_dtype == 1) LN_FWD(__nv_bfloat16, __nv_bfloat16);
#undef LN_FWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int ln_dx(const void* x, const void* gamma, const void* mu,
                     const void* rstd, const void* dy, void* dx, int rows,
                     int d, int x_dtype, int w_dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
#define LN_DX(T, W) \
  return (int)launch_dx<T, W>(x, gamma, mu, rstd, dy, dx, rows, d, st)
  if (x_dtype == 0 && w_dtype == 0) LN_DX(float, float);
  if (x_dtype == 0 && w_dtype == 1) LN_DX(float, __nv_bfloat16);
  if (x_dtype == 1 && w_dtype == 0) LN_DX(__nv_bfloat16, float);
  if (x_dtype == 1 && w_dtype == 1) LN_DX(__nv_bfloat16, __nv_bfloat16);
#undef LN_DX
  return (int)cudaErrorInvalidValue;
}
