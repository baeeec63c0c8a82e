// Ragged paged attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/ragged_paged_attention.py::_ragged_kernel
// (launched by ragged_paged_attention(), pallas_call at :508), with float
// pools and with int8 pools (quant=True: codes under per-page-per-head
// float32 scales, dequantised inside the page gather as _dequant does,
// :322-329). One program serves every serving attention mode: decode
// (s = 1), cold prefill (ctx = 0), prefix-tail prefill (ctx = cached
// tokens) and the K+1 verify shape. Query t of row b attends pool positions
// j <= ctx_lens[b] + t, gathered page by page through page_table[b], up to
// the table width pages_per_seq * page_size.
//
// What bounds it on this card: at decode (s = 1) each (row, head) reads
// its whole KV prefix once for 4*d operations per position, so the kernel
// is bound by device-memory bytes (2 * ctx * h * d * itemsize per row at
// 3.35 TB/s; int8 pools halve the bf16 bytes, plus 8 bytes of scales per
// page and head). At a long prefill the causal score and PV products dominate
// (4 * s * ctx_eff * h * d operations) and a tensor-core kernel would be
// compute-bound; this one runs them on the CUDA cores.
//
// What the design does about it:
// - the pool is read once per (row, head, query block): each 32-position
//   tile of K and V is gathered through the page table into shared memory
//   and reused by every query warp of the block (up to 8 queries);
// - the gather is asynchronous (cp.async, 16 bytes per copy) into a
//   two-stage ring, so the next tile's loads are in flight while the
//   current tile is computed — device-memory latency is not paid per load;
// - the loop stops at the last position any query of the block can see,
//   so masked pages are never read;
// - scores: lane jj of a warp computes the whole dot product of its query
//   with position j0 + jj, reading its K row in 16-byte pieces; rows are
//   padded by 16 bytes whatever the element size, so the 8 lanes of each
//   quarter-warp 16-byte read hit distinct banks; the query sits in shared
//   memory as float32 and is read by broadcast;
// - int8 pools: the tile holds the codes and, beside it, each position's
//   page scale for this head over 127 (K and V, one float each), gathered
//   with the tile; each code is dequantised in registers as
//   (float)code * (scale / 127), then rounded to q's dtype before the
//   score and PV products, as paged_gather_quant + the composite do. The
//   null page's scale holds whatever dead writes left there, but no
//   position past a query's limit is ever dequantised into a product;
// - online softmax (running max m, sum l) and the float32 PV accumulator
//   stay in registers; nothing but the output is written.
// Later work: tensor cores (wgmma) for the prefill products, TMA, and
// split-KV so that a small decode batch (b * h blocks of one warp) fills
// all 132 SMs.
//
// Layouts (all contiguous):
//   q, out        [b, h, s, d]            float32 or bfloat16
//   k/v pool      [num_pages, page_size, h, d]   q's dtype, or int8 codes
//   k/v scale     [num_pages, h] float32   (int8 pools only)
//   page_table    [b, pages_per_seq] int32
//   ctx_lens      [b] int32
// Launch: grid (ceil(s / W), h, b), W = min(s, 8) warps, one per query.
// For PV each lane holds d / 32 accumulator elements (lane + 32 r).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 32;     // KV positions per stage: one per lane
constexpr int kMaxWarps = 8;  // query rows per block

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

// x rounded to T and back: the dequantised value in q's dtype
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// one staged KV element as the float the products use: the element itself
// for float pools; for int8 pools the code times its position's
// scale / 127, rounded to q's dtype T
template <typename T, typename KV>
__device__ __forceinline__ float kv_value(KV x, float sc) {
  if constexpr (std::is_same<KV, int8_t>::value)
    return round_to<T>(__fmul_rn((float)x, sc));
  else
    return to_f32(x);
}

// dot product of one 16-byte piece of a K row with the matching query
// elements (float32, from shared memory); sc is the row's dequant factor
template <typename T, typename KV>
__device__ __forceinline__ float dot16(uint4 raw, const float* q, float acc,
                                       float sc) {
  if constexpr (std::is_same<KV, float>::value) {
    const float4 k = *reinterpret_cast<const float4*>(&raw);
    const float4 a = *reinterpret_cast<const float4*>(q);
    acc = fmaf(k.x, a.x, acc);
    acc = fmaf(k.y, a.y, acc);
    acc = fmaf(k.z, a.z, acc);
    return fmaf(k.w, a.w, acc);
  } else if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
    const __nv_bfloat162* k = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 a = *reinterpret_cast<const float4*>(q);
    const float4 b = *reinterpret_cast<const float4*>(q + 4);
    float2 k0 = __bfloat1622float2(k[0]), k1 = __bfloat1622float2(k[1]);
    float2 k2 = __bfloat1622float2(k[2]), k3 = __bfloat1622float2(k[3]);
    acc = fmaf(k0.x, a.x, acc);
    acc = fmaf(k0.y, a.y, acc);
    acc = fmaf(k1.x, a.z, acc);
    acc = fmaf(k1.y, a.w, acc);
    acc = fmaf(k2.x, b.x, acc);
    acc = fmaf(k2.y, b.y, acc);
    acc = fmaf(k3.x, b.z, acc);
    return fmaf(k3.y, b.w, acc);
  } else {  // int8 codes
    const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 a = *reinterpret_cast<const float4*>(q + 4 * g);
      acc = fmaf(kv_value<T>(c[g].x, sc), a.x, acc);
      acc = fmaf(kv_value<T>(c[g].y, sc), a.y, acc);
      acc = fmaf(kv_value<T>(c[g].z, sc), a.z, acc);
      acc = fmaf(kv_value<T>(c[g].w, sc), a.w, acc);
    }
    return acc;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);  // all but the newest group
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename KV, int D>
struct Layout {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kVec = 16 / sizeof(KV);  // elements per 16 bytes
  static constexpr int kChunks = D / kVec;      // 16-byte pieces per row
  static constexpr int kStride = D + kVec;      // padded row, elements
  static constexpr int kStage = 2 * kTile * kStride;  // K tile + V tile
  // per stage, the K and V dequant factors of each position (int8 only)
  static constexpr int kScales = kQuant ? 2 * kTile : 0;
  // two stages of K and V tiles, their dequant factors, then one float32
  // query row per warp
  static constexpr size_t kSmemBytes = 2 * kStage * sizeof(KV) +
                                       2 * kScales * sizeof(float) +
                                       kMaxWarps * D * sizeof(float);
};

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const KV* __restrict__ k_pool,
                              const KV* __restrict__ v_pool,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ page_table,
                              const int* __restrict__ ctx_lens,
                              T* __restrict__ out, int h, int s,
                              int page_size, int pages_per_seq, float scale) {
  using L = Layout<KV, D>;
  constexpr int R = D / 32;  // accumulator elements per lane
  extern __shared__ __align__(16) unsigned char smem[];
  KV* tiles = reinterpret_cast<KV*>(smem);  // [stage][K, V][kTile][kStride]
  // [stage][K, V][kTile] dequant factors (int8 pools)
  float* sc_s = reinterpret_cast<float*>(tiles + 2 * L::kStage);
  float* q_s = sc_s + 2 * L::kScales;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int t0 = blockIdx.x * nwarps;
  const int t = t0 + warp;
  const bool has_query = t < s;  // warp-uniform

  const int ctx = ctx_lens[row];
  const int total = pages_per_seq * page_size;
  const int t_last = min(t0 + nwarps, s) - 1;
  // positions any query of this block can see; position 0 always is
  const int n_kv = min(ctx + t_last + 1, total);
  const int n_tiles = (n_kv + kTile - 1) / kTile;
  const int limit = ctx + t;  // this query sees j <= limit

  const int* table = page_table + (size_t)row * pages_per_seq;
  const size_t token_stride = (size_t)h * D;  // pool elements per position
  const size_t q_off =
      (((size_t)row * h + head) * s + (has_query ? t : 0)) * D;

  float* qw = q_s + warp * D;
  for (int i = lane; i < D; i += 32)
    qw[i] = has_query ? to_f32(q[q_off + i]) : 0.f;

  // gather tile `tile` of the row's positions into ring stage `stage`
  auto gather_tile = [&](int tile, int stage) {
    const int j0 = tile * kTile;
    const int n = min(kTile, n_kv - j0);
    KV* ks = tiles + stage * L::kStage;
    KV* vs = ks + kTile * L::kStride;
    for (int i = threadIdx.x; i < n * L::kChunks; i += blockDim.x) {
      const int jj = i / L::kChunks;
      const int c = i - jj * L::kChunks;
      const int j = j0 + jj;
      const size_t off =
          ((size_t)table[j / page_size] * page_size + j % page_size) *
              token_stride +
          (size_t)head * D + (size_t)c * L::kVec;
      cp_async16(ks + jj * L::kStride + c * L::kVec, k_pool + off);
      cp_async16(vs + jj * L::kStride + c * L::kVec, v_pool + off);
    }
    if constexpr (L::kQuant) {
      // the exact paged_gather_quant factor: scale / 127, a true division
      float* ksc = sc_s + stage * L::kScales;
      for (int jj = threadIdx.x; jj < n; jj += blockDim.x) {
        const size_t at = (size_t)table[(j0 + jj) / page_size] * h + head;
        ksc[jj] = __fdiv_rn(k_scale[at], 127.0f);
        ksc[kTile + jj] = __fdiv_rn(v_scale[at], 127.0f);
      }
    }
  };

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  float m = -INFINITY;  // running max of visible scores
  float l = 0.f;        // running sum of exp(score - m)

  gather_tile(0, 0);
  cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) gather_tile(tile + 1, (tile + 1) & 1);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_prior();
    __syncthreads();  // tile `tile` (and the query rows) visible to all
    if (has_query) {
      const KV* ks = tiles + (tile & 1) * L::kStage;
      const KV* vs = ks + kTile * L::kStride;
      const float* ksc = sc_s + (tile & 1) * L::kScales;
      const float* vsc = ksc + kTile;
      const int j0 = tile * kTile;
      const int n_tile = min(kTile, n_kv - j0);
      const bool visible = lane < n_tile && j0 + lane <= limit;
      float score = -INFINITY;
      if (visible) {
        const uint4* krow =
            reinterpret_cast<const uint4*>(ks + lane * L::kStride);
        const float sc = L::kQuant ? ksc[lane] : 0.f;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          dot = dot16<T, KV>(krow[c], qw + c * L::kVec, dot, sc);
        score = dot * scale;
      }
      // m_new is finite: tile 0 holds position 0, visible to every query
      const float m_new = fmaxf(m, warp_max(score));
      const float alpha = expf(m - m_new);  // 0 on the first tile
      const float p = visible ? expf(score - m_new) : 0.f;
      l = l * alpha + warp_sum(p);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] *= alpha;
      // positions past this query's limit have p = 0: stop at the last one
      const int n_pv = min(n_tile, limit - j0 + 1);
      for (int jj = 0; jj < n_pv; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        const KV* vrow = vs + jj * L::kStride;
        const float sc = L::kQuant ? vsc[jj] : 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] = fmaf(pj, kv_value<T>(vrow[lane + 32 * r], sc), acc[r]);
      }
      m = m_new;
    }
    __syncthreads();  // stage `tile & 1` is free for tile + 2
  }

  if (has_query) {
    T* o = out + q_off;
#pragma unroll
    for (int r = 0; r < R; ++r) o[lane + 32 * r] = from_f32<T>(acc[r] / l);
  }
}

template <typename T, typename KV, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* page_table, const void* ctx_lens, void* out,
                   int b, int h, int s, int page_size, int pages_per_seq,
                   float scale, cudaStream_t stream) {
  const int nwarps = s < kMaxWarps ? s : kMaxWarps;
  const dim3 grid((s + nwarps - 1) / nwarps, h, b);
  const size_t smem = Layout<KV, D>::kSmemBytes;
  auto kernel = ragged_paged_attention_kernel<T, KV, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, nwarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(page_table),
      static_cast<const int*>(ctx_lens), static_cast<T*>(out), h, s,
      page_size, pages_per_seq, scale);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t dispatch_head_dim(int d, const void* q, const void* k_pool,
                              const void* v_pool, const void* k_scale,
                              const void* v_scale, const void* page_table,
                              const void* ctx_lens, void* out, int b, int h,
                              int s, int page_size, int pages_per_seq,
                              float scale, cudaStream_t stream) {
#define RPA_CASE(D)                                                        \
  case D:                                                                  \
    return launch<T, KV, D>(q, k_pool, v_pool, k_scale, v_scale,           \
                            page_table, ctx_lens, out, b, h, s, page_size, \
                            pages_per_seq, scale, stream);
  switch (d) {
    RPA_CASE(32)
    RPA_CASE(64)
    RPA_CASE(96)
    RPA_CASE(128)
    RPA_CASE(160)
    RPA_CASE(192)
    RPA_CASE(224)
    RPA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef RPA_CASE
}

}  // namespace

// C entry point, loaded with ctypes. dtype (q, out and float pools):
// 0 = float32, 1 = bfloat16. quant = 1: the pools are int8 codes and
// k_scale / v_scale their [num_pages, h] float32 scales (else both are
// ignored). Launches on `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError() after the launch (0 = success).
extern "C" int ragged_paged_attention(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* k_scale,
                                      const void* v_scale,
                                      const void* page_table,
                                      const void* ctx_lens, void* out, int b,
                                      int h, int s, int d, int page_size,
                                      int pages_per_seq, float scale,
                                      int dtype, int quant, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || h <= 0 || s <= 0 || page_size <= 0 || pages_per_seq <= 0)
    return (int)cudaErrorInvalidValue;
  if (quant && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
#define RPA_DISPATCH(T, KV)                                                 \
  return (int)dispatch_head_dim<T, KV>(d, q, k_pool, v_pool, k_scale,       \
                                       v_scale, page_table, ctx_lens, out, \
                                       b, h, s, page_size, pages_per_seq,   \
                                       scale, st)
  if (dtype == 0 && !quant) RPA_DISPATCH(float, float);
  if (dtype == 1 && !quant) RPA_DISPATCH(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 0 && quant) RPA_DISPATCH(float, int8_t);
  if (dtype == 1 && quant) RPA_DISPATCH(__nv_bfloat16, int8_t);
#undef RPA_DISPATCH
  return (int)cudaErrorInvalidValue;
}
