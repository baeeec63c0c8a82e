// Dropout for Hopper (sm_90a): the reference's mask, generated from its key
// in the forward and kept as bits for the backward.
//
// The reference has no Pallas kernel here: paddle_tpu/nn/functional.py
// `dropout` (:688) is XLA, `jnp.where(bernoulli(key, 1 - p, shape), a /
// (1 - p), 0)`, with the bits of jax.random under x64 and the
// partitionable threefry. The forward gives the same output bit for bit:
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
//
// The mask is kept as bits: bit j % 8 of byte j / 8 is keep of mask index
// j (the flat index in the mask's own shape, which with the reference's
// `axis` is a broadcast shape, 1 along every dimension not in it). Where
// autograd records, the forward writes them; the backward reads them and
// takes no key: dx = where(bit, dy / q, 0) (dy for downscale_in_infer),
// XLA's VJP of the reference's `jnp.where`, which keeps `keep` as a
// residual. A recomputed forward (remat) writes them again from the key.
//
// What bounds it on this card:
// - the forward: integer instructions, not bytes. One threefry2x32 an
//   element is the floor that keeps the reference's bits (each element's
//   52-bit uniform takes both output words of one hash): 20 rounds of add,
//   funnel-shift rotate and xor, 5 key injections of 2 additions, then
//   the compare and the bit. About 75 INT32 instructions an element,
//   against 2 to 16 bytes; chip_smoke.py counts them in the compiled code.
// - the backward: bytes (dy read, dx written, one bit an element read).
// What the design does about it:
// - a thread takes 8 consecutive elements a step: one byte of the mask,
//   its x and y as 16-byte vectors (one of bf16, two of float32, four of
//   float64) where both pointers are 16-byte aligned;
// - a 32-bit index where the mask has fewer than 2^31 elements: the
//   counter's high word is then 0, so the first key addition of x1 is the
//   key word itself; the 52-bit compare is two 32-bit compares;
// - a broadcast mask is hashed once a mask element (its own launch, over
//   the mask's shape), then applied by the backward's kernel, whose
//   broadcast index is carried as a counter across a thread's 8 elements;
// - grid-stride loops, at most 8 blocks of 256 threads an SM.
//
// A window (dropout_forward_window): the tensor is a slice of a larger
// one that the reference masks whole (a rank's rows and heads of a
// hybrid-parallel step), so mask index j is the element's flat index in
// the full mask: j = base + sum_d c_d * gstride_d over the slice's
// coordinates c. The windowed kernel forms it once a group of 8 and
// carries it as a counter across the group, as the broadcast index is
// carried; j is 64 bits. It writes the slice's mask bits only, and the
// backward's kernel applies them, as for a broadcast mask: two launches.
// Its own kernel, so that the unwindowed forward's code (whose
// instructions chip_smoke.py counts) stays as it is; applying in it too
// made the float64 instance spill around the division's call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_record.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDims = 8;
constexpr int kGroup = 8;  // elements a thread a step: one byte of the mask

struct Broadcast {
  long long dims[kMaxDims];     // the output's shape, row-major
  long long mstride[kMaxDims];  // the mask's stride per dim, 0: broadcast
  int ndim;                     // 0: the mask is the output's shape
};

// A slice of the full mask: the local mask's dims (merged, unit dims
// dropped), each one's stride in the full mask, and the full-mask index of
// the slice's origin.
struct Window {
  long long dims[kMaxDims];
  long long gstride[kMaxDims];
  long long base;
  int ndim;
};

// The keep threshold split at bit 20: threshold = hi * 2^20 + lo, lo <=
// 2^20 (lo = 2^20 only for threshold = 2^52, p = 0, where hi = 2^32 - 1).
struct Threshold {
  uint32_t hi, lo;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r)     \
  x1 += x2;             \
  x2 = rotl(x2, r) ^ x1;

// threefry2x32, 20 rounds, as paddle_tpu_torch/random.py threefry2x32, on
// the counter (hi, lo); keep = the 52-bit word below the threshold
__device__ __forceinline__ bool keep_bit(uint32_t k1, uint32_t k2,
                                         uint32_t hi, uint32_t lo,
                                         Threshold t) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  uint32_t x1 = hi + k1;  // hi = 0 for a 32-bit index: folded away
  uint32_t x2 = lo + k2;
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
  // m = x1 * 2^20 + (x2 >> 12) < t.hi * 2^20 + t.lo
  return x1 < t.hi || (x1 == t.hi && (x2 >> 12) < t.lo);
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
__device__ __forceinline__ float narrow(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 narrow(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ double narrow(double v, double) { return v; }

// y[i0 .. i0 + 7] = the mask byte applied to x[i0 .. i0 + 7] (below n):
// 16-byte vectors for a whole group when `vec`, else element by element
template <typename T>
__device__ __forceinline__ void apply_group(const T* __restrict__ x,
                                            T* __restrict__ y, long long i0,
                                            long long n, uint32_t byte,
                                            double q, int upscale, int vec) {
  constexpr int kVecs = kGroup * (int)sizeof(T) / 16;
  if (vec && i0 + kGroup <= n) {
    uint4 raw[kVecs];
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
      raw[v] = __ldg(reinterpret_cast<const uint4*>(x + i0) + v);
    T* e = reinterpret_cast<T*>(raw);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const auto a = widen(e[k]);
      e[k] = narrow((byte >> k) & 1u ? (upscale ? divide(a, q) : a)
                                     : decltype(a)(0), T());
    }
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
      reinterpret_cast<uint4*>(y + i0)[v] = raw[v];
    return;
  }
  for (int k = 0; k < kGroup && i0 + k < n; ++k) {
    const auto a = widen(x[i0 + k]);
    y[i0 + k] = narrow((byte >> k) & 1u ? (upscale ? divide(a, q) : a)
                                        : decltype(a)(0), T());
  }
}

// The forward over n elements whose mask is their own shape (kApply), or
// the mask alone over n mask elements (!kApply: x and y unused). Idx is
// uint32_t below 2^31 elements, else unsigned long long. bits may be null
// (kApply only): nothing records the mask.
template <typename T, typename Idx, bool kApply>
__global__ void __launch_bounds__(kThreads)
dropout_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                   uint8_t* __restrict__ bits, Idx n, uint32_t k1,
                   uint32_t k2, Threshold t, double q, int upscale,
                   int vec) {
  const Idx groups = (n + kGroup - 1) / kGroup;
  const Idx stride = (Idx)gridDim.x * kThreads;
  for (Idx g = (Idx)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += stride) {
    const Idx i0 = g * kGroup;
    uint32_t byte = 0;
    if (i0 + kGroup <= n) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const Idx j = i0 + k;
        const uint32_t hi = sizeof(Idx) > 4 ? (uint32_t)((uint64_t)j >> 32)
                                            : 0u;
        byte |= (uint32_t)keep_bit(k1, k2, hi, (uint32_t)j, t) << k;
      }
    } else {
      for (int k = 0; k < kGroup && i0 + k < n; ++k) {
        const Idx j = i0 + k;
        const uint32_t hi = sizeof(Idx) > 4 ? (uint32_t)((uint64_t)j >> 32)
                                            : 0u;
        byte |= (uint32_t)keep_bit(k1, k2, hi, (uint32_t)j, t) << k;
      }
    }
    if (!kApply || bits != nullptr) bits[g] = (uint8_t)byte;
    if (kApply)
      apply_group(x, y, (long long)i0, (long long)n, byte, q, upscale, vec);
  }
}

// The mask bits of a slice (see Window) over its n mask elements: as
// dropout_fwd_kernel's, each element's counter its index in the full mask.
__global__ void __launch_bounds__(kThreads)
dropout_window_kernel(uint8_t* __restrict__ bits, long long n, uint32_t k1,
                      uint32_t k2, Threshold t, const Window w) {
  const long long groups = (n + kGroup - 1) / kGroup;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const long long i0 = g * kGroup;
    long long c[kMaxDims], rem = i0;
    unsigned long long j = (unsigned long long)w.base;
    for (int d = w.ndim - 1; d >= 0; --d) {
      c[d] = rem % w.dims[d];
      rem /= w.dims[d];
      j += (unsigned long long)(c[d] * w.gstride[d]);
    }
    uint32_t byte = 0;
    for (int k = 0; k < kGroup && i0 + k < n; ++k) {
      byte |= (uint32_t)keep_bit(k1, k2, (uint32_t)(j >> 32), (uint32_t)j,
                                 t) << k;
      for (int d = w.ndim - 1; d >= 0; --d) {  // the next element
        j += (unsigned long long)w.gstride[d];
        if (++c[d] < w.dims[d]) break;
        j -= (unsigned long long)(c[d] * w.gstride[d]);
        c[d] = 0;
      }
    }
    bits[g] = (uint8_t)byte;
  }
}

// The byte of mask bits for elements g * 8 .. g * 8 + 7 (below n): byte g
// of the bits, or with a broadcast mask the bits of each element's mask
// index, from its coordinates and the mask's strides, computed once and
// then carried as a counter.
template <bool kBcast>
__device__ __forceinline__ uint32_t mask_byte(const uint8_t* __restrict__ bits,
                                              long long g, long long n,
                                              const Broadcast& bc) {
  if (!kBcast) return __ldg(bits + g);
  const long long i0 = g * kGroup;
  long long c[kMaxDims], rem = i0, j = 0;
  for (int d = bc.ndim - 1; d >= 0; --d) {
    c[d] = rem % bc.dims[d];
    rem /= bc.dims[d];
    j += c[d] * bc.mstride[d];
  }
  uint32_t byte = 0;
  for (int k = 0; k < kGroup && i0 + k < n; ++k) {
    byte |= ((uint32_t)__ldg(bits + (j >> 3)) >> (j & 7) & 1u) << k;
    for (int d = bc.ndim - 1; d >= 0; --d) {  // the next element
      j += bc.mstride[d];
      if (++c[d] < bc.dims[d]) break;
      j -= c[d] * bc.mstride[d];
      c[d] = 0;
    }
  }
  return byte;
}

// The mask's bits applied to n elements: the backward (x = dy, y = dx) and
// a broadcast mask's forward (kBcast).
template <typename T, bool kBcast>
__global__ void __launch_bounds__(kThreads)
dropout_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const uint8_t* __restrict__ bits, long long n, double q,
                     int upscale, int vec, const Broadcast bc) {
  const long long groups = (n + kGroup - 1) / kGroup;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < groups; g += stride)
    apply_group(x, y, g * kGroup, n, mask_byte<kBcast>(bits, g, n, bc), q,
                upscale, vec);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// blocks of a grid-stride launch over n elements, 8 a thread
cudaError_t grid_for(long long n, unsigned* blocks) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  const long long groups = (n + kGroup - 1) / kGroup;
  const long long want = (groups + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  *blocks = (unsigned)(want < cap ? want : cap);
  return err;
}

template <typename T, bool kApply>
cudaError_t launch_fwd(const void* x, void* y, void* bits, long long n,
                       uint32_t k1, uint32_t k2, Threshold t, double q,
                       int upscale, cudaStream_t st) {
  unsigned blocks;
  const cudaError_t err = grid_for(n, &blocks);
  if (err != cudaSuccess) return err;
  if (launch_record::note(dim3(blocks), kThreads, 0)) return cudaSuccess;
  const int vec = kApply && aligned16(x) && aligned16(y);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  uint8_t* b = static_cast<uint8_t*>(bits);
  if (n < (1ll << 31))
    dropout_fwd_kernel<T, uint32_t, kApply><<<blocks, kThreads, 0, st>>>(
        xt, yt, b, (uint32_t)n, k1, k2, t, q, upscale, vec);
  else
    dropout_fwd_kernel<T, unsigned long long, kApply>
        <<<blocks, kThreads, 0, st>>>(xt, yt, b, (unsigned long long)n, k1,
                                      k2, t, q, upscale, vec);
  return cudaGetLastError();
}

cudaError_t launch_window(void* bits, long long m, uint32_t k1, uint32_t k2,
                          Threshold t, const Window& w, cudaStream_t st) {
  unsigned blocks;
  const cudaError_t err = grid_for(m, &blocks);
  if (err != cudaSuccess) return err;
  if (launch_record::note(dim3(blocks), kThreads, 0)) return cudaSuccess;
  dropout_window_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<uint8_t*>(bits), m, k1, k2, t, w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_apply(const void* x, void* y, const void* bits,
                         long long n, double q, int upscale,
                         const Broadcast& bc, cudaStream_t st) {
  unsigned blocks;
  const cudaError_t err = grid_for(n, &blocks);
  if (err != cudaSuccess) return err;
  if (launch_record::note(dim3(blocks), kThreads, 0)) return cudaSuccess;
  const int vec = aligned16(x) && aligned16(y);
  if (bc.ndim == 0)
    dropout_apply_kernel<T, false><<<blocks, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(y),
        static_cast<const uint8_t*>(bits), n, q, upscale, vec, bc);
  else
    dropout_apply_kernel<T, true><<<blocks, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(y),
        static_cast<const uint8_t*>(bits), n, q, upscale, vec, bc);
  return cudaGetLastError();
}

// The broadcast of (ndim, dims, mstrides), validated
int read_broadcast(int ndim, const long long* dims, const long long* mstrides,
                   Broadcast* bc) {
  if (ndim < 0 || ndim > kMaxDims) return (int)cudaErrorInvalidValue;
  *bc = Broadcast{};
  bc->ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    if (dims[d] <= 0 || mstrides[d] < 0) return (int)cudaErrorInvalidValue;
    bc->dims[d] = dims[d];
    bc->mstride[d] = mstrides[d];
  }
  return 0;
}

// The window of (ndim, dims, gstrides, base), validated
int read_window(int ndim, const long long* dims, const long long* gstrides,
                long long base, Window* w) {
  if (ndim < 0 || ndim > kMaxDims || base < 0)
    return (int)cudaErrorInvalidValue;
  *w = Window{};
  w->ndim = ndim;
  w->base = base;
  for (int d = 0; d < ndim; ++d) {
    if (dims[d] <= 0 || gstrides[d] < 0) return (int)cudaErrorInvalidValue;
    w->dims[d] = dims[d];
    w->gstride[d] = gstrides[d];
  }
  return 0;
}

}  // namespace

// C entry points, loaded with ctypes. dtype: 0 float32, 1 bfloat16, 2
// float64, x and y contiguous (they may be the same buffer). Each launches
// on `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after its launches (0 = success).
//
// dropout_forward: y = dropout(x) over n elements under the key words (k1,
// k2); (t_hi, t_lo): the threshold ceil((1 - p) * 2^52) split at bit 20
// (t_hi * 2^20 + t_lo); q: 1 - p rounded to the dtype; upscale: 1 for
// upscale_in_train (divide kept values by q), 0 for downscale_in_infer.
// ndim = 0: the mask is x's shape (m = n): one launch, writing the mask's
// bits to `bits` (ceil(n / 8) bytes) unless it is null. ndim > 0: the
// mask broadcasts: m mask elements, dims[ndim] the output's shape and
// mstrides[ndim] the mask's element strides (0 along a broadcast
// dimension); two launches, the mask's bits (`bits` required) and then
// their application.
extern "C" int dropout_forward(const void* x, void* y, void* bits,
                               long long n, int dtype, unsigned int k1,
                               unsigned int k2, unsigned int t_hi,
                               unsigned int t_lo, double q, int upscale,
                               int ndim, const long long* dims,
                               const long long* mstrides, long long m,
                               void* stream) {
  Broadcast bc;
  int bad = read_broadcast(ndim, dims, mstrides, &bc);
  if (bad || n <= 0 || m <= 0 || dtype < 0 || dtype > 2 ||
      (ndim == 0 && m != n) || (ndim > 0 && bits == nullptr) ||
      t_lo > (1u << 20))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Threshold t{t_hi, t_lo};
  if (ndim == 0) {
    if (dtype == 0)
      return (int)launch_fwd<float, true>(x, y, bits, n, k1, k2, t, q,
                                          upscale, st);
    if (dtype == 1)
      return (int)launch_fwd<__nv_bfloat16, true>(x, y, bits, n, k1, k2, t,
                                                  q, upscale, st);
    return (int)launch_fwd<double, true>(x, y, bits, n, k1, k2, t, q,
                                         upscale, st);
  }
  cudaError_t err = launch_fwd<float, false>(nullptr, nullptr, bits, m, k1,
                                             k2, t, q, upscale, st);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    return (int)launch_apply<float>(x, y, bits, n, q, upscale, bc, st);
  if (dtype == 1)
    return (int)launch_apply<__nv_bfloat16>(x, y, bits, n, q, upscale, bc,
                                            st);
  return (int)launch_apply<double>(x, y, bits, n, q, upscale, bc, st);
}

// dropout_forward_window: dropout_forward of a slice of a larger tensor
// (see Window): the same arguments, and the window over the m local mask
// elements, (wndim, wdims, wstrides, wbase) as random.window_counters
// gives them. Two launches: the mask's bits (`bits` required), then their
// application (broadcast where ndim > 0).
extern "C" int dropout_forward_window(
    const void* x, void* y, void* bits, long long n, int dtype,
    unsigned int k1, unsigned int k2, unsigned int t_hi, unsigned int t_lo,
    double q, int upscale, int ndim, const long long* dims,
    const long long* mstrides, long long m, int wndim,
    const long long* wdims, const long long* wstrides, long long wbase,
    void* stream) {
  Broadcast bc;
  Window w;
  int bad = read_broadcast(ndim, dims, mstrides, &bc);
  if (!bad) bad = read_window(wndim, wdims, wstrides, wbase, &w);
  if (bad || n <= 0 || m <= 0 || dtype < 0 || dtype > 2 ||
      (ndim == 0 && m != n) || bits == nullptr || t_lo > (1u << 20))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Threshold t{t_hi, t_lo};
  cudaError_t err = launch_window(bits, m, k1, k2, t, w, st);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    return (int)launch_apply<float>(x, y, bits, n, q, upscale, bc, st);
  if (dtype == 1)
    return (int)launch_apply<__nv_bfloat16>(x, y, bits, n, q, upscale, bc,
                                            st);
  return (int)launch_apply<double>(x, y, bits, n, q, upscale, bc, st);
}

// dropout_backward: dx = where(bit, dy / q, 0) over n elements (dy itself
// for downscale_in_infer, upscale 0) from the forward's bits; ndim, dims
// and mstrides as for dropout_forward. One launch.
extern "C" int dropout_backward(const void* dy, void* dx, const void* bits,
                                long long n, int dtype, double q, int upscale,
                                int ndim, const long long* dims,
                                const long long* mstrides, void* stream) {
  Broadcast bc;
  int bad = read_broadcast(ndim, dims, mstrides, &bc);
  if (bad || n <= 0 || dtype < 0 || dtype > 2 || bits == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_apply<float>(dy, dx, bits, n, q, upscale, bc, st);
  if (dtype == 1)
    return (int)launch_apply<__nv_bfloat16>(dy, dx, bits, n, q, upscale, bc,
                                            st);
  return (int)launch_apply<double>(dy, dx, bits, n, q, upscale, bc, st);
}

// The launches of dropout_forward (backward = 0) or dropout_backward
// (backward = 1) over n elements whose mask is their own shape, without
// making them (see launch_record.cuh). Returns the launch count, or the
// entry point's error negated.
extern "C" int dropout_geometry(int backward, long long n, int dtype,
                                int* out, int max) {
  void* p = launch_record::fake_ptr();
  launch_record::Scope scope(out, max);
  const int err =
      backward ? dropout_backward(p, p, p, n, dtype, 1.0, 1, 0, nullptr,
                                  nullptr, nullptr)
               : dropout_forward(p, p, p, n, dtype, 0u, 0u, 0u, 0u, 1.0, 1,
                                 0, nullptr, nullptr, n, nullptr);
  return launch_record::result(scope, err);
}
