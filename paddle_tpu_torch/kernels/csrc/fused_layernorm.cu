// Fused LayerNorm forward and backward for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/fused_layernorm.py::_ln_fwd_kernel (launched
// by _call_fwd, pallas_call at :69) and ::_ln_dx_kernel (launched by
// _call_dx, pallas_call at :93) together with the sums over rows that the
// reference's _vjp_bwd (:130-142) leaves to XLA. Over rows of x [rows, d]:
//
//   forward  mu = mean(x); var = mean((x - mu)^2); rstd = 1 / sqrt(var + eps)
//            y = (x - mu) * rstd * gamma + beta        (y in x's dtype)
//   backward xhat = (x - mu) * rstd; wdy = dy * gamma
//            dx = rstd * (wdy - mean(wdy) - xhat * mean(wdy * xhat))
//            dgamma = sum over rows of dy * xhat; dbeta = sum over rows of dy
//
// all in float32; mu and rstd are written as float32 [rows]; dgamma and
// dbeta are cast once to gamma's dtype.
//
// What bounds it on this card: bytes. Each element takes about ten
// operations against 4 to 6 bytes moved (x read and y written; x and dy
// read and dx written), far below the card's 295 operations per byte.
//
// Forward: one warp owns a row, eight rows to a block: the row's sums are
// warp shuffles, with no shared memory and no block barrier; lanes walk
// the row 16 bytes at a time (4 float32 or 8 bf16 values, neighbouring
// lanes on neighbouring addresses) when d and every pointer allow it,
// element by element otherwise; the two-pass mean and variance (the
// reference's order, :34-35) and the output pass re-read the row from
// L1/L2 instead of holding it in registers, so d is not bounded by the
// register file (the wrapper states a maximum of 65,536).
//
// Backward: one pass over x and dy writes dx and, without float atomics,
// float32 column partials of dy * xhat and dy, which a second small kernel
// sums in a fixed order into dgamma and dbeta: the results are equal from
// run to run. Two programs, chosen by shape:
// - rows (d a multiple of 8, d <= 1,024, 16-byte aligned pointers: every
//   training shape): one persistent block of 16 warps an SM. A row is
//   taken by a group of N = ceil(d / 256) warps, each lane owning the
//   same 8 columns of every row the group visits (16 bytes of bf16 or 32
//   of float32), so its x, dy, gammas and column partials sit in
//   registers, the loads of the group's next rows are in flight while one
//   is computed, and the row's two sums are warp shuffles and, across the
//   group's warps, a named barrier; the block adds its groups' partials
//   in group order and writes one partial row [d] a block;
// - strips (any d up to 65,536): the forward's layout, eight rows a
//   block, each row re-read from L1/L2 for its second pass; the eight
//   warps' partials of each 32-vector column chunk meet in shared memory
//   and the block writes one partial row a strip.
// The reduction reads the [parts, d] partials, 32 columns a block, eight
// slices of parts summed in order and then added in slice order.
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, ...: no
// fused multiply-add contraction) in the reference's order; only the
// order of the sums differs from the plain version.
//
// Layouts (all contiguous): x, y, dy, dx [rows, d] float32 or bfloat16;
// gamma, beta, dgamma, dbeta [d] float32 or bfloat16 (one dtype for all);
// mu, rstd [rows] float32; partials [2, parts, d] float32 (dgamma's, then
// dbeta's). Launches: forward grid ceil(rows / 8), 256 threads; backward
// rows grid min(ceil(rows / (16 / N)), SMs), 512 threads, or strips grid
// ceil(rows / 8), 256 threads;
// reduction grid ceil(d / 32), 256 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "launch_record.cuh"

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

constexpr int kRowCols = 8;     // columns a lane owns (rows program)
constexpr int kMaxRowSteps = 4;  // rows program: d <= 32 * 8 * 4 = 1,024
constexpr int kRowWarps = 16;    // rows program: warps a block, a block an SM

// 8 consecutive elements of T as they lie in memory (16 or 32 bytes)
template <typename T>
struct Raw8 {
  uint4 v[kRowCols * sizeof(T) / 16];
};

template <typename T>
__device__ __forceinline__ void load_raw(const T* __restrict__ p,
                                         Raw8<T>& r) {
#pragma unroll
  for (int v = 0; v < (int)(sizeof(Raw8<T>) / 16); ++v)
    r.v[v] = __ldg(reinterpret_cast<const uint4*>(p) + v);
}

template <typename T>
__device__ __forceinline__ void unpack_raw(const Raw8<T>& r,
                                           float (&out)[kRowCols]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int v = 0; v < kRowCols / kPer; ++v)
    unpack16(r.v[v], out + v * kPer, T());
}

// Rows program: a row is taken by a group of N warps, warp w of the group
// owning columns (w * 32 + lane) * 8 .. + 7 of every row, so each lane
// holds 8 elements of x and of dy a row, its 8 gammas and its 16 column
// partials in registers. A block of 16 warps has 16 / N groups; group g
// of block b takes rows b * G + g, then every gridDim.x * G rows further,
// with the next kDepth - 1 rows' loads in flight while one is computed.
// The row's two sums meet across the group's warps in shared memory
// behind a named barrier (double-buffered by the row's parity); at the
// end the block adds its groups' partials in group order.
template <typename T, typename W, int N>
__global__ void __launch_bounds__(kRowWarps * 32, 1)
ln_bwd_rows_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
                   const float* __restrict__ mu_in,
                   const float* __restrict__ rstd_in,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ parts, int rows, int d) {
  constexpr int G = kRowWarps / N;  // rows a block computes at once
  constexpr int kCols = N * 32 * kRowCols;
  constexpr int kDepth = sizeof(T) == 2 ? 3 : 2;  // rows a group holds
  __shared__ float acc_s[G * 2 * kCols];
  __shared__ float2 sums[G][2][N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp / N, part = warp % N;
  const bool active = group < G;  // N = 3 leaves a warp idle
  const int col = (part * 32 + lane) * kRowCols;
  const bool live = active && col < d;
  const float fd = (float)d;
  float g[kRowCols], ag[kRowCols], ab[kRowCols];
#pragma unroll
  for (int i = 0; i < kRowCols; ++i) ag[i] = ab[i] = 0.f;
  if (live) load_n<kRowCols>(gamma + col, g);

  Raw8<T> rx[kDepth], rdy[kDepth];
  float rmu[kDepth], rrs[kDepth];
  const int stride = gridDim.x * G;
  int row = blockIdx.x * G + group;
#pragma unroll
  for (int k = 0; k + 1 < kDepth; ++k) {  // fill all but the last slot
    const int r = row + k * stride;
    if (active && r < rows) {
      if (live) {
        load_raw(x + (size_t)r * d + col, rx[k]);
        load_raw(dy + (size_t)r * d + col, rdy[k]);
      }
      rmu[k] = mu_in[r];
      rrs[k] = rstd_in[r];
    }
  }
  for (int it = 0; active && row < rows; ++it, row += stride) {
    const int ahead = row + (kDepth - 1) * stride;
    if (ahead < rows) {
      if (live) {
        load_raw(x + (size_t)ahead * d + col, rx[kDepth - 1]);
        load_raw(dy + (size_t)ahead * d + col, rdy[kDepth - 1]);
      }
      rmu[kDepth - 1] = mu_in[ahead];
      rrs[kDepth - 1] = rstd_in[ahead];
    }
    const float mu = rmu[0], rstd = rrs[0];
    float v[kRowCols], t[kRowCols];
    float s_wdy = 0.f, s_wdy_xhat = 0.f;
    if (live) {
      unpack_raw(rx[0], v);
      unpack_raw(rdy[0], t);
#pragma unroll
      for (int i = 0; i < kRowCols; ++i) {
        v[i] = __fmul_rn(__fsub_rn(v[i], mu), rstd);  // xhat
        const float wdy = __fmul_rn(t[i], g[i]);
        s_wdy = __fadd_rn(s_wdy, wdy);
        s_wdy_xhat = __fadd_rn(s_wdy_xhat, __fmul_rn(wdy, v[i]));
      }
    }
    s_wdy = warp_sum(s_wdy);
    s_wdy_xhat = warp_sum(s_wdy_xhat);
    if constexpr (N > 1) {  // the group's warps' sums, in warp order
      if (lane == 0) sums[group][it & 1][part] = make_float2(s_wdy,
                                                             s_wdy_xhat);
      asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(N * 32));
      float2 s = sums[group][it & 1][0];
#pragma unroll
      for (int w = 1; w < N; ++w) {
        const float2 o = sums[group][it & 1][w];
        s.x = __fadd_rn(s.x, o.x);
        s.y = __fadd_rn(s.y, o.y);
      }
      s_wdy = s.x;
      s_wdy_xhat = s.y;
    }
    const float c1 = __fdiv_rn(s_wdy, fd);
    const float c2 = __fdiv_rn(s_wdy_xhat, fd);
    if (live) {
#pragma unroll
      for (int i = 0; i < kRowCols; ++i) {
        const float xhat = v[i];
        const float wdy = __fmul_rn(t[i], g[i]);
        ag[i] = __fadd_rn(ag[i], __fmul_rn(t[i], xhat));
        ab[i] = __fadd_rn(ab[i], t[i]);
        v[i] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(wdy, c1),
                                         __fmul_rn(xhat, c2)));
      }
      if (dx != nullptr) store_n<kRowCols>(dx + (size_t)row * d + col, v);
    }
#pragma unroll
    for (int k = 0; k + 1 < kDepth; ++k) {  // the next row into slot 0
      rx[k] = rx[k + 1];
      rdy[k] = rdy[k + 1];
      rmu[k] = rmu[k + 1];
      rrs[k] = rrs[k + 1];
    }
  }
  if (parts == nullptr) return;  // uniform across the block
  if (live) {
#pragma unroll
    for (int i = 0; i < kRowCols; ++i) {
      acc_s[(group * 2) * kCols + col + i] = ag[i];
      acc_s[(group * 2 + 1) * kCols + col + i] = ab[i];
    }
  }
  __syncthreads();
  // the block's partial rows: its groups added in group order
  for (int k = threadIdx.x; k < 2 * d; k += kRowWarps * 32) {
    const int which = k >= d, c = which ? k - d : k;
    float s = acc_s[which * kCols + c];
#pragma unroll
    for (int w = 1; w < G; ++w)
      s = __fadd_rn(s, acc_s[(w * 2 + which) * kCols + c]);
    parts[((size_t)which * gridDim.x + blockIdx.x) * d + c] = s;
  }
}

// Strips program: block b takes rows b * 8 .. b * 8 + 7, a warp a row;
// lanes walk the row one vector (16 bytes) or one element at a time.
template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_strips_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
                     const float* __restrict__ mu_in,
                     const float* __restrict__ rstd_in,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ parts, int rows, int d) {
  // elements per lane per step: 16 bytes of T in the vector mode, else 1
  constexpr int N = kVec ? 16 / (int)sizeof(T) : 1;
  constexpr int kChunk = 32 * N;  // columns a step of the warp
  __shared__ float red[2][kWarps][kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  const bool live = row < rows;  // a dead warp still meets the barriers
  const size_t off = (size_t)(live ? row : 0) * d;
  const float mu = live ? mu_in[row] : 0.f;
  const float rstd = live ? rstd_in[row] : 0.f;
  const float fd = (float)d;

  float s_wdy = 0.f, s_wdy_xhat = 0.f;
  for (int e = lane * N; live && e < d; e += kChunk) {
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

  for (int base = 0; base < d; base += kChunk) {
    const int e = base + lane * N;
    float pg[N], pb[N];
#pragma unroll
    for (int i = 0; i < N; ++i) pg[i] = pb[i] = 0.f;
    if (live && e < d) {
      float v[N], g[N], t[N];
      load_n<N>(x + off + e, v);
      load_n<N>(gamma + e, g);
      load_n<N>(dy + off + e, t);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float xhat = __fmul_rn(__fsub_rn(v[i], mu), rstd);
        const float wdy = __fmul_rn(t[i], g[i]);
        pg[i] = __fmul_rn(t[i], xhat);
        pb[i] = t[i];
        v[i] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(wdy, c1),
                                         __fmul_rn(xhat, c2)));
      }
      if (dx != nullptr) store_n<N>(dx + off + e, v);
    }
    if (parts == nullptr) continue;  // uniform across the block
#pragma unroll
    for (int i = 0; i < N; ++i) {
      red[0][warp][lane * N + i] = pg[i];
      red[1][warp][lane * N + i] = pb[i];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < 2 * kChunk; k += kWarps * 32) {
      const int which = k / kChunk, col = base + k % kChunk;
      if (col < d) {
        float s = red[which][0][k % kChunk];
#pragma unroll
        for (int w = 1; w < kWarps; ++w)
          s = __fadd_rn(s, red[which][w][k % kChunk]);
        parts[((size_t)which * gridDim.x + blockIdx.x) * d + col] = s;
      }
    }
    __syncthreads();
  }
}

constexpr int kSlices = 8;  // reduction: slices of parts a block

// dgamma[col], dbeta[col] = the sums of partials[0 or 1][.][col]: thread
// (slice, lane) adds parts slice, slice + 8, ... in order, then the
// slices are added in order.
template <typename W>
__global__ void __launch_bounds__(kSlices * 32)
ln_bwd_reduce_kernel(const float* __restrict__ parts, int n_parts, int d,
                     W* __restrict__ dgamma, W* __restrict__ dbeta) {
  __shared__ float red[2][kSlices][32];
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float sg = 0.f, sb = 0.f;
  if (col < d) {
    const float* pg = parts + col;
    const float* pb = parts + (size_t)n_parts * d + col;
#pragma unroll 4
    for (int p = slice; p < n_parts; p += kSlices) {
      sg = __fadd_rn(sg, pg[(size_t)p * d]);
      sb = __fadd_rn(sb, pb[(size_t)p * d]);
    }
  }
  red[0][slice][lane] = sg;
  red[1][slice][lane] = sb;
  __syncthreads();
  if (slice < 2 && col < d) {
    float s = red[slice][0][lane];
#pragma unroll
    for (int k = 1; k < kSlices; ++k) s = __fadd_rn(s, red[slice][k][lane]);
    (slice == 0 ? dgamma : dbeta)[col] = from_f32<W>(s);
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
  if (launch_record::note(grid, kWarps * 32, 0)) return cudaSuccess;
  const bool vec = vector_mode<T>(d, {x, gamma, beta, y});
  auto kernel = vec ? ln_fwd_kernel<T, W, true> : ln_fwd_kernel<T, W, false>;
  kernel<<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(gamma),
      static_cast<const W*>(beta), static_cast<T*>(y),
      static_cast<float*>(mu), static_cast<float*>(rstd), rows, d, eps);
  return cudaGetLastError();
}

int sm_count(cudaError_t* err) {
  int device = 0, sms = 0;
  *err = cudaGetDevice(&device);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
  return sms;
}

// The backward's program: the rows program's N (0: the strips program),
// the strips program's vector mode, and the grid (= the partial rows).
struct BwdPlan {
  int steps;
  bool vec;
  int grid;
};

template <typename T>
BwdPlan bwd_plan(int rows, int d, bool aligned, int sms) {
  constexpr int kCols = 32 * kRowCols;
  if (aligned && d % kRowCols == 0 && d <= kCols * kMaxRowSteps) {
    const int n = (d + kCols - 1) / kCols, groups = kRowWarps / n;
    const int blocks = (rows + groups - 1) / groups;
    return {n, true, blocks < sms ? blocks : sms};
  }
  return {0, aligned && d % (16 / (int)sizeof(T)) == 0,
          (rows + kWarps - 1) / kWarps};
}

template <typename T, typename W>
cudaError_t launch_bwd(const void* x, const void* gamma, const void* mu,
                       const void* rstd, const void* dy, void* dx,
                       void* parts, void* dgamma, void* dbeta, int rows,
                       int d, int n_parts, cudaStream_t stream) {
  cudaError_t err;
  const int sms = sm_count(&err);
  if (err != cudaSuccess) return err;
  const bool aligned = aligned16(x) && aligned16(gamma) && aligned16(dy) &&
                       (dx == nullptr || aligned16(dx));
  const BwdPlan plan = bwd_plan<T>(rows, d, aligned, sms);
  if (parts != nullptr && n_parts != plan.grid) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const W* g = static_cast<const W*>(gamma);
  const float* m = static_cast<const float*>(mu);
  const float* r = static_cast<const float*>(rstd);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  float* pt = static_cast<float*>(parts);
  const dim3 grid(plan.grid);
  const int threads = plan.steps ? kRowWarps * 32 : kWarps * 32;
  if (!launch_record::note(grid, threads, 0)) {
    switch (plan.steps) {
#define LN_ROWS(n)                                                     \
  case n:                                                              \
    ln_bwd_rows_kernel<T, W, n><<<grid, threads, 0, stream>>>(         \
        xt, g, m, r, dyt, dxt, pt, rows, d);                           \
    break;
      LN_ROWS(1) LN_ROWS(2) LN_ROWS(3) LN_ROWS(4)
#undef LN_ROWS
      default:
        if (plan.vec)
          ln_bwd_strips_kernel<T, W, true><<<grid, threads, 0, stream>>>(
              xt, g, m, r, dyt, dxt, pt, rows, d);
        else
          ln_bwd_strips_kernel<T, W, false><<<grid, threads, 0, stream>>>(
              xt, g, m, r, dyt, dxt, pt, rows, d);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (parts == nullptr) return cudaSuccess;
  const dim3 columns((d + 31) / 32);
  if (launch_record::note(columns, kSlices * 32, 0)) return cudaSuccess;
  ln_bwd_reduce_kernel<W><<<columns, kSlices * 32, 0, stream>>>(
      pt, plan.grid, d, static_cast<W*>(dgamma), static_cast<W*>(dbeta));
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

// dx (may be null: parameters only) and, with `parts` ([2, n_parts, d]
// float32 scratch, n_parts the program's grid; null: dx only), dgamma and
// dbeta in w_dtype. One launch of the backward kernel, plus the reduction
// when `parts` is given.
extern "C" int ln_backward(const void* x, const void* gamma, const void* mu,
                           const void* rstd, const void* dy, void* dx,
                           void* parts, void* dgamma, void* dbeta, int rows,
                           int d, int n_parts, int x_dtype, int w_dtype,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0 || (dx == nullptr && parts == nullptr))
    return (int)cudaErrorInvalidValue;
#define LN_BWD(T, W)                                                    \
  return (int)launch_bwd<T, W>(x, gamma, mu, rstd, dy, dx, parts, dgamma, \
                               dbeta, rows, d, n_parts, st)
  if (x_dtype == 0 && w_dtype == 0) LN_BWD(float, float);
  if (x_dtype == 0 && w_dtype == 1) LN_BWD(float, __nv_bfloat16);
  if (x_dtype == 1 && w_dtype == 0) LN_BWD(__nv_bfloat16, float);
  if (x_dtype == 1 && w_dtype == 1) LN_BWD(__nv_bfloat16, __nv_bfloat16);
#undef LN_BWD
  return (int)cudaErrorInvalidValue;
}

// The launches of ln_forward (mode 0), ln_backward for dx alone (mode 1)
// or for dx, dgamma and dbeta (mode 2) at these shapes, without making
// them (see launch_record.cuh). Returns the launch count, or the entry
// point's error negated.
extern "C" int ln_geometry(int mode, int rows, int d, int x_dtype,
                           int w_dtype, int* out, int max) {
  void* p = launch_record::fake_ptr();
  int parts = 0;  // the partial rows ln_backward takes: its grid
  if (mode == 2) {
    cudaError_t err;
    const int sms = sm_count(&err);
    if (err != cudaSuccess) return -(int)err;
    parts = x_dtype == 0 ? bwd_plan<float>(rows, d, true, sms).grid
                         : bwd_plan<__nv_bfloat16>(rows, d, true, sms).grid;
  }
  launch_record::Scope scope(out, max);
  const int err =
      mode == 0 ? ln_forward(p, p, p, p, p, p, rows, d, 1e-5f, x_dtype,
                             w_dtype, nullptr)
                : ln_backward(p, p, p, p, p, p, mode == 2 ? p : nullptr, p,
                              p, rows, d, parts, x_dtype, w_dtype, nullptr);
  return launch_record::result(scope, err);
}
