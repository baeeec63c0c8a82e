// Ragged paged attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/ragged_paged_attention.py::_ragged_kernel
// (launched by ragged_paged_attention(), pallas_call at :508), with float
// pools and with int8 pools (quant=True: codes under per-page-per-head
// float32 scales, dequantised inside the page gather as _dequant does,
// :322-329). It serves every serving attention mode: decode (s = 1), cold
// prefill (ctx = 0), prefix-tail prefill (ctx = cached tokens) and the K+1
// verify shape. Query t of row b attends pool positions
// j <= ctx_lens[b] + t, gathered page by page through page_table[b], up to
// the table width pages_per_seq * page_size.
//
// What bounds it on this card: at decode (s = 1) each (row, head) reads
// its whole KV prefix once for 4*d operations per position, so the call
// is bound by device-memory bytes (2 * ctx * h * d * itemsize per row at
// 3.35 TB/s; int8 pools halve the bf16 bytes, plus 8 bytes of scales per
// page and head). A 512-token prefill does 4 * d operations per visible
// (query, position) pair, 2.2 GFLOP at h = 16, d = 128: 2 us at the bf16
// tensor-core rate, 33 us on the CUDA cores, against 4 MB of K/V and q.
//
// Three programs; the wrapper picks one from the shapes and dtypes alone
// (never from ctx_lens on the host), and each has its own launch counter:
//
// split (s <= kSplitMaxQ: decode and verify; any dtype, float or int8
//   pools). Bytes bound it, and a grid of b * h blocks would leave most of
//   the 132 SMs idle at batch 8 and all but 16 at batch 1, with too few
//   bytes in flight to cover the memory latency. So
//   the table width is cut into `splits` chunks of a multiple of 64
//   positions, the count chosen by the wrapper from b, h and the SM count
//   so that b * h * splits blocks of 4 warps fill the card at batch 8 and
//   at batch 1. A block gathers its chunk through the page table in tiles
//   of up to 64 positions (cp.async, two stages), every warp working on
//   the same tile: all 128 threads compute scores (one (query, position)
//   pair each), a warp per query updates the online softmax, and each
//   thread accumulates one output element over the tile. It writes float32
//   partials (running max m, sum l, the unnormalised accumulator); a split
//   that starts past the row's last visible position writes m = -inf,
//   l = 0 and reads no page. A second kernel merges the partials by
//   log-sum-exp and rounds once to q's dtype (one split: the block writes
//   the output itself). Split 0 holds position 0, which every query sees,
//   so the merge never divides by zero.
//
// mma (bf16 q, s >= the wrapper's threshold, head_dim <= 128: prefill and
//   prefix tail). The score and PV products run on the tensor cores,
//   mma.sync m16n8k16 with the ldmatrix helpers of mma_bf16.cuh, the
//   flash forward's register layout: a block owns 64 queries of one (row,
//   head), 4 warps of 16, and walks the row's visible prefix in 64-position
//   tiles gathered page by page through the table into shared memory
//   (cp.async, two stages); tiles wholly past the block's last visible
//   position are not loaded, the diagonal tile is masked, positions past it
//   are zero-filled (src_bytes = 0) so no garbage enters a product, and P
//   is rounded to bf16 before PV as the plain version rounds it. int8
//   pools stage the codes and each position's page scale (cp.async) and
//   dequantise them to bf16 in shared memory before the products,
//   positions past the last visible one written as zeros and never
//   dequantised. Why mma.sync
//   and not wgmma: the 512-token bucket is 8 query blocks x 16 heads = 128
//   blocks, one wave, each walking at most 8 tiles; its tensor-core work is
//   2 us at the dense rate, so the tile loads and the softmax bound it,
//   not the instruction's rate. head_dim 160-256 keeps the warp program:
//   its float32 accumulator rows do not fit in registers beside the score
//   tile.
//
// warp (everything else: float32 q above kSplitMaxQ queries, bf16 below
//   the mma threshold or above head_dim 128). The CUDA-core program:
//   - the pool is read once per (row, head, query block): each 32-position
//     tile of K and V is gathered through the page table into shared
//     memory and reused by every query warp of the block (up to 8
//     queries), through a two-stage cp.async ring;
//   - the loop stops at the last position any query of the block can see,
//     so masked pages are never read;
//   - scores: lane jj of a warp computes the whole dot product of its
//     query with position j0 + jj; the query sits in shared memory as
//     float32 and is read by broadcast; online softmax and the float32 PV
//     accumulator stay in registers.
//
// Shared by the split and warp programs: K/V rows are staged padded by 16
// bytes whatever the element size, so the 8 lanes of each quarter-warp
// 16-byte read hit distinct banks; a split block stages each position with
// a few threads that read its page id once, a tile ahead; int8 pools stage
// each position's page scale for this head over 127 (K and V, one float
// each) beside the tile and dequantise each code in registers as
// (float)code * (scale / 127),
// rounded to q's dtype before the score and PV products, as
// paged_gather_quant + the composite do. The null page's scale holds
// whatever dead writes left there, but no position past a query's limit
// is ever dequantised into a product.
//
// Layouts (all contiguous):
//   q, out        [b, h, s, d]            float32 or bfloat16
//   k/v pool      [num_pages, page_size, h, d]   q's dtype, or int8 codes
//   k/v scale     [num_pages, h] float32   (int8 pools only)
//   page_table    [b, pages_per_seq] int32
//   ctx_lens      [b] int32
//   part_o        [b, h, s, splits, d] float32   (split program, splits > 1)
//   part_ml       [b, h, s, splits, 2] float32   (m, l)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "launch_record.cuh"
#include "mma_bf16.cuh"

namespace {

using mma_bf16::bf16;
using mma_bf16::cp_async16;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait_prior;

// 4-byte asynchronous copy (an int8 page's scale); src_bytes = 0 writes 0
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

constexpr int kTile = 32;     // warp program: KV positions per stage
constexpr int kMaxWarps = 8;  // warp program: query rows per block

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
ragged_warp_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                   const KV* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ page_table,
                   const int* __restrict__ ctx_lens, T* __restrict__ out,
                   int h, int s, int page_size, int pages_per_seq,
                   float scale) {
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
      cp_async16(ks + jj * L::kStride + c * L::kVec, k_pool + off, 16);
      cp_async16(vs + jj * L::kStride + c * L::kVec, v_pool + off, 16);
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

// ---------------------------------------------------------------------------
// split program: decode and verify

constexpr int kSplitThreads = 128;  // 4 warps on one chunk
constexpr int kSplitMaxQ = 8;       // queries a split block serves
constexpr int kSplitQuantum = 64;   // a chunk is a multiple of this many
                                    // positions (and of every stage tile)
constexpr int kStageBudget = 40 * 1024;  // bytes of one stage's K, V tiles
constexpr int kMergeThreads = 128;
constexpr int kMaxSplits = 256;  // the merge keeps every split's weight

template <typename KV, int D>
struct SplitLayout {
  using W = Layout<KV, D>;
  static constexpr int kRowBytes = W::kStride * sizeof(KV);
  // positions per stage: 64 where two stages stay within the budget
  static constexpr int kTileN = 2 * 64 * kRowBytes <= kStageBudget   ? 64
                                : 2 * 32 * kRowBytes <= kStageBudget ? 32
                                                                     : 16;
  static constexpr int kStage = 2 * kTileN * W::kStride;  // K + V, elements
  static constexpr int kScales = W::kQuant ? 2 * kTileN : 0;
  // stage 0's K and V tiles, both stages' page scales (dequant factors
  // once consumed), the float32 queries, the score tile, m, l and the
  // rescale of each query, then stage 1's tiles: a chunk of one tile never
  // touches stage 1, so its blocks leave it out and more fit on an SM
  static constexpr size_t kOneStageBytes =
      kStage * sizeof(KV) + 2 * kScales * sizeof(float) +
      kSplitMaxQ * D * sizeof(float) + kSplitMaxQ * kTileN * sizeof(float) +
      3 * kSplitMaxQ * sizeof(float);
  static constexpr size_t kSmemBytes = kOneStageBytes + kStage * sizeof(KV);
};

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kSplitThreads)
ragged_split_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                    const KV* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ ctx_lens,
                    float* __restrict__ part_o, float* __restrict__ part_ml,
                    T* __restrict__ out, int h, int s, int page_size,
                    int pages_per_seq, int chunk, float scale) {
  using W = Layout<KV, D>;
  using L = SplitLayout<KV, D>;
  constexpr int kT = L::kTileN;
  constexpr int R = kSplitMaxQ * D / kSplitThreads;  // outputs per thread
  extern __shared__ __align__(16) unsigned char smem[];
  KV* tiles0 = reinterpret_cast<KV*>(smem);  // [K, V][kT][kStride]
  float* sc_s = reinterpret_cast<float*>(tiles0 + L::kStage);
  float* q_s = sc_s + 2 * L::kScales;  // [s][D]
  float* p_s = q_s + kSplitMaxQ * D;   // [s][kT]: scores, then p
  float* m_s = p_s + kSplitMaxQ * kT;  // running max of each query
  float* l_s = m_s + kSplitMaxQ;       // running sum
  float* a_s = l_s + kSplitMaxQ;       // this tile's rescale
  KV* tiles1 = reinterpret_cast<KV*>(a_s + kSplitMaxQ);  // stage 1
  auto stage_tiles = [&](int stage) { return stage ? tiles1 : tiles0; };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int splits = gridDim.x;
  const int total = pages_per_seq * page_size;
  const int j_begin = split * chunk;
  const int* table = page_table + (size_t)row * pages_per_seq;
  // each position of a tile is staged by kPer threads: one page-table
  // read per thread and tile, not one per 16-byte piece
  constexpr int kPer = kSplitThreads / kT;
  const int my_jj = tid / kPer;
  const int my_part = tid - my_jj * kPer;
  // this thread's page in the first tile, read beside ctx
  const int page_first = table[min(j_begin + my_jj, total - 1) / page_size];
  const int ctx = ctx_lens[row];
  const int n_kv = min(ctx + s, total);  // positions the last query sees
  const int j_end = min(j_begin + chunk, n_kv);
  const size_t qi0 = ((size_t)row * h + head) * s;  // (row, head, query 0)

  if (j_begin >= j_end) {  // block-uniform: nothing here is visible
    if (tid < s) {
      float* ml = part_ml + ((qi0 + tid) * splits + split) * 2;
      ml[0] = -INFINITY;
      ml[1] = 0.f;
    }
    return;
  }

  const size_t token_stride = (size_t)h * D;  // pool elements per position
  const int n_tiles = (j_end - j_begin + kT - 1) / kT;

  // the page of this thread's position in tile `tile` (0 past the chunk)
  auto page_of = [&](int tile) {
    const int j = j_begin + tile * kT + my_jj;
    return j < j_end ? table[j / page_size] : 0;
  };
  // tile `tile` of the chunk into ring stage `stage`
  auto gather_tile = [&](int tile, int stage, int page) {
    const int j = j_begin + tile * kT + my_jj;
    if (j >= j_end) return;
    KV* ks = stage_tiles(stage) + my_jj * W::kStride;
    KV* vs = ks + kT * W::kStride;
    const size_t base = ((size_t)page * page_size + j % page_size) *
                            token_stride +
                        (size_t)head * D;
    for (int c = my_part; c < W::kChunks; c += kPer) {
      cp_async16(ks + c * W::kVec, k_pool + base + c * W::kVec, 16);
      cp_async16(vs + c * W::kVec, v_pool + base + c * W::kVec, 16);
    }
    if constexpr (W::kQuant) {
      if (my_part == 0) {  // the page's scales; factors when consumed
        float* ksc = sc_s + stage * L::kScales;
        const size_t at = (size_t)page * h + head;
        cp_async4(ksc + my_jj, k_scale + at, 4);
        cp_async4(ksc + kT + my_jj, v_scale + at, 4);
      }
    }
  };

  gather_tile(0, 0, page_first);
  cp_async_commit();
  int page_next = n_tiles > 1 ? page_of(1) : 0;  // a tile ahead
  for (int i = tid; i < s * D; i += kSplitThreads)
    q_s[i] = to_f32(q[qi0 * D + i]);
  if (tid < kSplitMaxQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      gather_tile(tile + 1, (tile + 1) & 1, page_next);
      if (tile + 2 < n_tiles) page_next = page_of(tile + 2);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_prior();
    __syncthreads();  // tile `tile` (and the queries) visible to all
    const KV* ks = stage_tiles(tile & 1);
    const KV* vs = ks + kT * W::kStride;
    float* ksc = sc_s + (tile & 1) * L::kScales;
    const float* vsc = ksc + kT;
    const int j0 = j_begin + tile * kT;
    const int n_tile = min(kT, j_end - j0);
    if constexpr (W::kQuant) {
      // the exact paged_gather_quant factor: scale / 127, a true division
      if (tid < 2 * kT && tid % kT < n_tile)
        ksc[tid] = __fdiv_rn(ksc[tid], 127.0f);
      __syncthreads();
    }
    // the score of every (query, position) pair; invisible ones -inf
    for (int p = tid; p < s * kT; p += kSplitThreads) {
      const int t = p / kT;
      const int jj = p - t * kT;
      float x = -INFINITY;
      if (jj < n_tile && j0 + jj <= ctx + t) {
        const uint4* krow =
            reinterpret_cast<const uint4*>(ks + jj * W::kStride);
        const float sc = W::kQuant ? ksc[jj] : 0.f;
        const float* qt = q_s + t * D;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < W::kChunks; ++c)
          dot = dot16<T, KV>(krow[c], qt + c * W::kVec, dot, sc);
        x = dot * scale;
      }
      p_s[p] = x;
    }
    __syncthreads();
    // online softmax, a warp per query; a query may see nothing in this
    // split (verify: its limit lies before the chunk), then m stays -inf
    for (int t = warp; t < s; t += kSplitThreads / 32) {
      float* pt = p_s + t * kT;
      float mx = -INFINITY;
      for (int jj = lane; jj < kT; jj += 32) mx = fmaxf(mx, pt[jj]);
      const float m_old = m_s[t];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int jj = lane; jj < kT; jj += 32) {
        const float x = pt[jj];
        const float p = x == -INFINITY ? 0.f : expf(x - m_new);
        pt[jj] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        a_s[t] = alpha;
        l_s[t] = l_s[t] * alpha + sum;
        m_s[t] = m_new;
      }
    }
    __syncthreads();
    // PV: thread tid owns outputs o = tid + 128 r, query o / D, element
    // o % D (a warp's 32 outputs belong to one query)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int o = tid + kSplitThreads * r;
      if (o < s * D) {
        const int t = o / D;
        const int dd = o - t * D;
        const float* pt = p_s + t * kT;
        float a = acc[r] * a_s[t];
        // positions past query t's limit have p = 0: stop at its last one
        const int n_pv = min(n_tile, ctx + t - j0 + 1);
        for (int jj = 0; jj < n_pv; ++jj)
          a = fmaf(pt[jj],
                   kv_value<T>(vs[jj * W::kStride + dd],
                               W::kQuant ? vsc[jj] : 0.f),
                   a);
        acc[r] = a;
      }
    }
    __syncthreads();  // stage `tile & 1` and the score tile are free
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int o = tid + kSplitThreads * r;
    if (o < s * D) {
      const int t = o / D;
      if (splits == 1)
        out[qi0 * D + o] = from_f32<T>(acc[r] / l_s[t]);
      else
        part_o[((qi0 + t) * splits + split) * D + (o - t * D)] = acc[r];
    }
  }
  if (splits > 1 && tid < s) {
    float* ml = part_ml + ((qi0 + tid) * splits + split) * 2;
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
}

// one block per (row, head, query): the splits' partials weighted by
// exp(m_i - max m), summed, divided once, rounded once to T. Every (m, l)
// is read at once and the partial rows' loads are independent, so the
// merge costs a few memory round trips whatever the split count.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
ragged_merge_kernel(const float* __restrict__ part_o,
                    const float* __restrict__ part_ml, T* __restrict__ out,
                    int splits, int d) {
  __shared__ float w_s[kMaxSplits];  // each split's max, then its weight
  __shared__ float l_s[kMaxSplits];
  __shared__ float red[3][kMergeThreads / 32];
  const size_t qi = blockIdx.x;
  const float* ml = part_ml + qi * splits * 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float m = -INFINITY;
  for (int i = tid; i < splits; i += kMergeThreads) {
    w_s[i] = ml[2 * i];
    l_s[i] = ml[2 * i + 1];
    m = fmaxf(m, w_s[i]);
  }
  m = warp_max(m);
  if (lane == 0) red[0][warp] = m;
  __syncthreads();
  m = red[0][0];
#pragma unroll
  for (int w = 1; w < kMergeThreads / 32; ++w) m = fmaxf(m, red[0][w]);
  // m is finite: split 0 holds position 0, which every query sees
  float l = 0.f, used = 0.f;
  for (int i = tid; i < splits; i += kMergeThreads) {
    const bool seen = w_s[i] != -INFINITY;
    const float w = seen ? expf(w_s[i] - m) : 0.f;
    w_s[i] = w;
    l = fmaf(w, l_s[i], l);
    used += seen;
  }
  l = warp_sum(l);
  used = warp_sum(used);
  if (lane == 0) {
    red[1][warp] = l;
    red[2][warp] = used;
  }
  __syncthreads();
  l = used = 0.f;
#pragma unroll
  for (int w = 0; w < kMergeThreads / 32; ++w) {
    l += red[1][w];
    used += red[2][w];
  }
  // the splits a query sees anything in are a prefix (it sees the first
  // position of each up to its last); only they wrote part_o
  const int n_used = (int)used;
  for (int dd = tid; dd < d; dd += kMergeThreads) {
    float o = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_used; ++i)
      o = fmaf(w_s[i], part_o[(qi * splits + i) * d + dd], o);
    out[qi * d + dd] = from_f32<T>(o / l);
  }
}

// ---------------------------------------------------------------------------
// mma program: bf16 prefill and prefix tail on the tensor cores

constexpr int kMmaRows = 64;      // queries per block, positions per tile
constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

template <typename KV, int D>
struct MmaLayout {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kS = mma_bf16::kStride<D>;  // bf16 tile row stride
  static constexpr int kTileElems = kMmaRows * kS;
  static constexpr int kCodeStride = D + 16;  // int8 staging row, padded
  static constexpr int kCodeStage = 2 * kMmaRows * kCodeStride;  // K + V
  // the q tile, then bf16 pools: two stages of (K, V) tiles; int8 pools:
  // one (K, V) pair of dequantised tiles, two stages of codes and two of
  // each position's K and V page scale
  static constexpr size_t kSmemBytes =
      kQuant ? 3 * kTileElems * sizeof(bf16) + 2 * kCodeStage +
                   2 * 2 * kMmaRows * sizeof(float)
             : 5 * kTileElems * sizeof(bf16);
};

template <typename KV, int D>
__global__ void __launch_bounds__(kMmaThreads)
ragged_mma_kernel(const bf16* __restrict__ q, const KV* __restrict__ k_pool,
                  const KV* __restrict__ v_pool,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ page_table,
                  const int* __restrict__ ctx_lens, bf16* __restrict__ out,
                  int h, int s, int page_size, int pages_per_seq,
                  float scale) {
  using L = MmaLayout<KV, D>;
  constexpr int S = L::kS;
  constexpr int kVec = 16 / sizeof(KV);  // pool elements per 16 bytes
  constexpr int kChunks = D / kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + L::kTileElems;  // bf16 pools: [stage][K, V]; int8: [K, V]
  int8_t* code_s =
      reinterpret_cast<int8_t*>(kv_s + (L::kQuant ? 2 : 4) * L::kTileElems);
  float* sc_s = reinterpret_cast<float*>(code_s + 2 * L::kCodeStage);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * kMmaRows;  // heaviest first
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int total = pages_per_seq * page_size;
  const int* table = page_table + (size_t)row * pages_per_seq;
  // this thread's page in the first tile, read beside ctx
  const int page_first =
      table[min((int)(threadIdx.x >> 1), total - 1) / page_size];
  const int ctx = ctx_lens[row];
  const int t_last = min(t0 + kMmaRows, s) - 1;
  const int n_kv = min(ctx + t_last + 1, total);  // the block's last + 1
  const int n_tiles = (n_kv + kMmaRows - 1) / kMmaRows;
  const size_t token_stride = (size_t)h * D;
  const size_t q_base = ((size_t)row * h + head) * s;  // (row, head, 0)

  // the block's queries, zero past s
  for (int i = threadIdx.x; i < kMmaRows * (D / 8); i += kMmaThreads) {
    const int r = i / (D / 8);
    const int c = i - r * (D / 8);
    const bool ok = t0 + r < s;
    cp_async16(q_s + r * S + c * 8, q + (q_base + (ok ? t0 + r : 0)) * D + c * 8,
               ok ? 16 : 0);
  }

  // tile `tile` of the row's positions into ring stage `stage`, each
  // position staged by two threads (one page-table read each); positions
  // from n_kv on are zero-filled (and, int8, get factor 0)
  const int my_jj = threadIdx.x >> 1;
  const int my_part = threadIdx.x & 1;
  auto page_of = [&](int tile) {
    const int j = tile * kMmaRows + my_jj;
    return j < n_kv ? table[j / page_size] : 0;
  };
  auto gather = [&](int tile, int stage, int page) {
    const int j = tile * kMmaRows + my_jj;
    const bool ok = j < n_kv;
    KV* kd;
    int stride;
    if constexpr (L::kQuant) {
      kd = reinterpret_cast<KV*>(code_s + stage * L::kCodeStage);
      stride = L::kCodeStride;
    } else {
      kd = reinterpret_cast<KV*>(kv_s + stage * 2 * L::kTileElems);
      stride = S;
    }
    KV* vd = kd + kMmaRows * stride;
    const size_t base =
        ok ? ((size_t)page * page_size + j % page_size) * token_stride +
                 (size_t)head * D
           : 0;
    for (int c = my_part; c < kChunks; c += 2) {
      const size_t at = ok ? base + (size_t)c * kVec : 0;
      cp_async16(kd + my_jj * stride + c * kVec, k_pool + at, ok ? 16 : 0);
      cp_async16(vd + my_jj * stride + c * kVec, v_pool + at, ok ? 16 : 0);
    }
    if constexpr (L::kQuant) {
      if (my_part == 0) {  // the page's scales (0 past n_kv)
        float* f = sc_s + stage * 2 * kMmaRows;
        const size_t at = ok ? (size_t)page * h + head : 0;
        cp_async4(f + my_jj, k_scale + at, ok ? 4 : 0);
        cp_async4(f + kMmaRows + my_jj, v_scale + at, ok ? 4 : 0);
      }
    }
  };

  // int8: the staged codes of `stage` as bf16 K and V tiles, each code
  // times its position's scale / 127 rounded to bf16; past n_kv zeros
  auto dequant = [&](int tile, int stage) {
    const int8_t* codes = code_s + stage * L::kCodeStage;
    const float* f = sc_s + stage * 2 * kMmaRows;
    const int j0 = tile * kMmaRows;
    constexpr int kPieces = D / 16;  // 16 codes per piece
    for (int i = threadIdx.x; i < 2 * kMmaRows * kPieces; i += kMmaThreads) {
      const int kv = i / (kMmaRows * kPieces);  // 0: K, 1: V
      const int rem = i - kv * kMmaRows * kPieces;
      const int jj = rem / kPieces;
      const int c = rem - jj * kPieces;
      const int at = kv * kMmaRows + jj;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          codes + at * L::kCodeStride + c * 16);
      const int8_t* code = reinterpret_cast<const int8_t*>(&raw);
      const bool ok = j0 + jj < n_kv;
      // the exact paged_gather_quant factor: scale / 127, a true division
      const float fac = __fdiv_rn(f[at], 127.0f);
      __align__(16) bf16 vals[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        vals[e] = __float2bfloat16(ok ? __fmul_rn((float)code[e], fac) : 0.f);
      uint4* dst = reinterpret_cast<uint4*>(kv_s + kv * L::kTileElems +
                                            jj * S + c * 16);
      dst[0] = reinterpret_cast<const uint4*>(vals)[0];
      dst[1] = reinterpret_cast<const uint4*>(vals)[1];
    }
  };

  float acc[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  gather(0, 0, page_first);
  cp_async_commit();  // with the queries
  int page_next = n_tiles > 1 ? page_of(1) : 0;  // a tile ahead
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      gather(tile + 1, (tile + 1) & 1, page_next);
      if (tile + 2 < n_tiles) page_next = page_of(tile + 2);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const bf16* k_s;
    if constexpr (L::kQuant) {
      dequant(tile, tile & 1);
      __syncthreads();
      k_s = kv_s;
    } else {
      k_s = kv_s + (tile & 1) * 2 * L::kTileElems;
    }
    const bf16* v_s = k_s + L::kTileElems;
    const int j0 = tile * kMmaRows;

    float sc[8][4] = {};
    mma_bf16::mma_abt<D>(q_s, warp * 16, k_s, lane, sc);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // a padding row (past s) takes the last query's limit
      const int tq = min(t0 + warp * 16 + g + 8 * hh, s - 1);
      const int lim = min(ctx + tq, total - 1);  // last position it sees
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j0 + 8 * j + 2 * t + e;
          const float x = col > lim ? -INFINITY : sc[j][2 * hh + e] * scale;
          sc[j][2 * hh + e] = x;
          mx = fmaxf(mx, x);
        }
      // finite: tile 0 holds position 0, which every row sees
      const float m_new = fmaxf(m[hh], mma_bf16::quad_max(mx));
      const float alpha = expf(m[hh] - m_new);  // 0 on the first tile
      m[hh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(sc[j][2 * hh + e] - m_new);
          sc[j][2 * hh + e] = p;
          sum += p;
        }
      l[hh] = l[hh] * alpha + sum;  // this thread's part of the row sum
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * hh] *= alpha;
        acc[n][2 * hh + 1] *= alpha;
      }
    }
    mma_bf16::mma_px<D>(sc, v_s, lane, acc);
    __syncthreads();  // stage tile & 1 (and the dequantised pair) free
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float l_row = mma_bf16::quad_sum(l[hh]);
    mma_bf16::store_rows<D>(out, q_base, t0 + warp * 16 + g + 8 * hh, s, acc,
                            hh, 1.f / l_row, t);
  }
}

// ---------------------------------------------------------------------------
// launches

enum Program { kWarp = 0, kSplit = 1, kMma = 2 };

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *page_table,
      *ctx_lens;
  void *out, *part_o, *part_ml;
  int b, h, s, page_size, pages_per_seq, program, splits, chunk;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int D>
cudaError_t launch_warp(const Args& a) {
  const int nwarps = a.s < kMaxWarps ? a.s : kMaxWarps;
  const dim3 grid((a.s + nwarps - 1) / nwarps, a.h, a.b);
  const size_t smem = Layout<KV, D>::kSmemBytes;
  if (launch_record::note(grid, nwarps * 32, smem)) return cudaSuccess;
  auto kernel = ragged_warp_kernel<T, KV, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, nwarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k_pool),
      static_cast<const KV*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.ctx_lens), static_cast<T*>(a.out), a.h, a.s,
      a.page_size, a.pages_per_seq, a.scale);
  return cudaGetLastError();
}

template <typename T, typename KV, int D>
cudaError_t launch_split(const Args& a) {
  using L = SplitLayout<KV, D>;
  const size_t smem = a.chunk <= L::kTileN ? L::kOneStageBytes : L::kSmemBytes;
  if (launch_record::note(dim3(a.splits, a.h, a.b), kSplitThreads, smem)) {
    if (a.splits > 1)
      launch_record::note(dim3(a.b * a.h * a.s), kMergeThreads, 0);
    return cudaSuccess;
  }
  auto kernel = ragged_split_kernel<T, KV, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.h, a.b), kSplitThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k_pool),
      static_cast<const KV*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.ctx_lens), static_cast<float*>(a.part_o),
      static_cast<float*>(a.part_ml), static_cast<T*>(a.out), a.h, a.s,
      a.page_size, a.pages_per_seq, a.chunk, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  ragged_merge_kernel<T><<<a.b * a.h * a.s, kMergeThreads, 0, a.stream>>>(
      static_cast<const float*>(a.part_o),
      static_cast<const float*>(a.part_ml), static_cast<T*>(a.out), a.splits,
      D);
  return cudaGetLastError();
}

template <typename T, typename KV, int D>
cudaError_t launch_mma(const Args& a) {
  if constexpr (std::is_same<T, bf16>::value && D <= 128) {
    const size_t smem = MmaLayout<KV, D>::kSmemBytes;
    const dim3 grid((a.s + kMmaRows - 1) / kMmaRows, a.h, a.b);
    if (launch_record::note(grid, kMmaThreads, smem)) return cudaSuccess;
    auto kernel = ragged_mma_kernel<KV, D>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kMmaThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const KV*>(a.k_pool),
        static_cast<const KV*>(a.v_pool),
        static_cast<const float*>(a.k_scale),
        static_cast<const float*>(a.v_scale),
        static_cast<const int*>(a.page_table),
        static_cast<const int*>(a.ctx_lens), static_cast<bf16*>(a.out), a.h,
        a.s, a.page_size, a.pages_per_seq, a.scale);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;  // the tensor cores take bf16 q, d <= 128
  }
}

template <typename T, typename KV, int D>
cudaError_t launch(const Args& a) {
  switch (a.program) {
    case kWarp:
      return launch_warp<T, KV, D>(a);
    case kSplit:
      return launch_split<T, KV, D>(a);
    case kMma:
      return launch_mma<T, KV, D>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename KV>
cudaError_t dispatch_head_dim(int d, const Args& a) {
  switch (d) {
    case 32: return launch<T, KV, 32>(a);
    case 64: return launch<T, KV, 64>(a);
    case 96: return launch<T, KV, 96>(a);
    case 128: return launch<T, KV, 128>(a);
    case 160: return launch<T, KV, 160>(a);
    case 192: return launch<T, KV, 192>(a);
    case 224: return launch<T, KV, 224>(a);
    case 256: return launch<T, KV, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, loaded with ctypes. dtype (q, out and float pools):
// 0 = float32, 1 = bfloat16. quant = 1: the pools are int8 codes and
// k_scale / v_scale their [num_pages, h] float32 scales (else both are
// ignored). program: 0 = warp, 1 = split (s <= 8; `splits` chunks of
// `chunk` positions, a multiple of 64 covering the table width; part_o and
// part_ml the float32 partials when splits > 1), 2 = mma (bf16 q, d <= 128).
// Launches on `stream`, does not synchronise, allocates nothing, and
// returns cudaGetLastError() after the launches (0 = success).
extern "C" int ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* ctx_lens, void* out, void* part_o, void* part_ml, int b,
    int h, int s, int d, int page_size, int pages_per_seq, int program,
    int splits, int chunk, float scale, int dtype, int quant, void* stream) {
  const Args a{q,     k_pool, v_pool, k_scale, v_scale, page_table,
               ctx_lens, out, part_o, part_ml, b, h, s, page_size,
               pages_per_seq, program, splits, chunk, scale,
               static_cast<cudaStream_t>(stream)};
  if (b <= 0 || h <= 0 || s <= 0 || page_size <= 0 || pages_per_seq <= 0)
    return (int)cudaErrorInvalidValue;
  if (quant && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (program == kSplit &&
      (s > kSplitMaxQ || splits <= 0 || splits > kMaxSplits || chunk <= 0 ||
       chunk % kSplitQuantum ||
       (long long)splits * chunk < (long long)pages_per_seq * page_size ||
       (splits > 1 && (part_o == nullptr || part_ml == nullptr))))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && !quant) return (int)dispatch_head_dim<float, float>(d, a);
  if (dtype == 1 && !quant) return (int)dispatch_head_dim<bf16, bf16>(d, a);
  if (dtype == 0 && quant) return (int)dispatch_head_dim<float, int8_t>(d, a);
  if (dtype == 1 && quant) return (int)dispatch_head_dim<bf16, int8_t>(d, a);
  return (int)cudaErrorInvalidValue;
}

// The launches ragged_paged_attention would make for these shapes, without
// making them: out[5 i .. 5 i + 4] = grid x, y, z, threads, dynamic shared
// bytes of launch i (room for `max`). Returns the launch count, or the
// entry point's error negated.
extern "C" int ragged_paged_attention_geometry(
    int b, int h, int s, int d, int page_size, int pages_per_seq,
    int program, int splits, int chunk, int dtype, int quant, int* out,
    int max) {
  void* p = launch_record::fake_ptr();
  launch_record::Scope scope(out, max);
  const int err = ragged_paged_attention(
      p, p, p, p, p, p, p, p, p, p, b, h, s, d, page_size, pages_per_seq,
      program, splits, chunk, 1.f, dtype, quant, nullptr);
  return launch_record::result(scope, err);
}
