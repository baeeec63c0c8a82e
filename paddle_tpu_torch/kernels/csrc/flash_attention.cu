// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/flash_attention.py::_flash (the library
// Pallas TPU flash attention and its custom VJP, :152-178) and, through
// the causal tile skip, the splash route (_splash / _splash_kernel,
// :181-238): causal attention with the diagonal aligned bottom-right
// (query i sees keys j <= i + s_k - s_q) whose fully masked tiles are
// never loaded.
//
//   o   = softmax(q k^T * scale [causal]) v      lse = row logsumexp
//   dq, dk, dv from q, k, v, o, lse and do
//
// What bounds it on this card: at the training shape (b*h = 128,
// s = 1024, d = 64, bf16, causal) the forward does 4*d*s*(s+1)/2
// operations per (batch, head), 17.2 GFLOP, against 67.6 MB of q, k, v, o
// and lse: 0.0174 ms at 989 TFLOP/s, 0.0202 ms at 3.35 TB/s, so the bytes
// bound it by a little; the backward's five products, 43.0 GFLOP, bound it
// by operations (0.0435 ms).
//
// Two sets of kernels:
// - bfloat16 is Hopper's own, forward and backward: every product on
//   wgmma (the only instruction that reaches the card's dense rate), the
//   tiles of the side a block walks brought by TMA into a ring that a
//   producer keeps in flight behind full and empty mbarriers, so
//   loads overlap the products and the softmax. The forward: a
//   persistent block of two consumer warpgroups walks work items of 128
//   queries (64 a group), heaviest first, and for each the K/V tiles of 64
//   keys its rows see, through a four-stage ring that runs on from one
//   item into the next; probabilities stay in registers as the A operand
//   of O += P V, rounded to bf16 as the plain version rounds them. The
//   backward: a block owns 64 keys and walks the query tiles that see
//   them, dQ folded into the dK/dV pass and added into float32 with bulk
//   reduce-adds, so the pass runs the five products the bound counts (see
//   its section below);
// - float32 runs on the CUDA cores in float32 (a 16 x 16 thread grid, a
//   4 x 4 micro-tile per thread): the tensor cores have no full-float32
//   product, and float32 is the precision the checks compare against.
//
// What the design does about it:
// - the S x S score matrix never reaches device memory: a block walks
//   the other side in tiles with an online softmax (running max, running
//   sum, float32 accumulators in registers); bf16 in log2 units, so an
//   element of a tile wholly inside the visible region costs one
//   exp2(fma(s, scale log2 e, -m)) and no mask branch: only the diagonal
//   tiles and the tails take the masked path;
// - causal: a tile wholly above the diagonal is never loaded; the
//   float32 forward and the backward schedule the heaviest query blocks
//   first, the bf16 forward gives each block pairs of a heavy and a light
//   query block of one head, about equal work;
// - the bf16 forward: with one block per 128 queries a block's fixed
//   costs (its launch, the first q and K/V loads, the O store) took a
//   large share of the time at the training shape, since the registers
//   allow one block an SM; the persistent grid loads the next item's q
//   and tiles while the current one finishes and lets the O store run
//   on. Two consumer warpgroups share each K/V tile, so one group's
//   softmax overlaps the other's products, and within a group tile i's S
//   product overlaps tile i - 1's P V. ptxas reports at most 168
//   registers a thread of the 384-thread block: tiles of 64 keys keep a
//   consumer's q, S, P and O within them (128-key tiles, or a second S
//   buffer to overlap the softmax with the next scores, spilled). The
//   producer warpgroup still gives its registers up to the consumers
//   (setmaxnreg): without it the head_dim 128 kernel spills. O leaves by
//   one TMA store a group (rows past s_q clipped), lse = m + log l in
//   float32;
// - float32 tiles are staged in shared memory with cp.async (16 bytes per
//   copy, zero-filled past the sequence end) into a two-stage ring; rows
//   are padded by 16 bytes so 16-byte reads hit distinct banks;
// - the float32 backward is three kernels: delta = rowsum(do * o); one
//   block per key tile accumulating dk and dv over the query tiles that
//   see it; one block per query tile accumulating dq (no atomics:
//   deterministic). The bfloat16 backward is a prep kernel (delta, a
//   padded copy of lse, the float32 dq accumulator zeroed), the fused
//   dk/dv/dq kernel and a pass that scales dq and rounds it to bf16.
//
// Shapes: any s_q, s_k >= 1 (tails are masked, there is no padding route:
// the TPU kernel's block-multiple rules and its tuned block table have no
// counterpart here). Masked logits are filled with -1e30 as the plain
// version does, so a causal row that sees no key at all (s_q > s_k) gets
// the mean of v, and no gradient flows into its scores.
//
// Layouts (all contiguous): q, o, do, dq [b, h, s_q, d]; k, v, dk, dv
// [b, h, s_k, d], float32 or bfloat16; lse, delta [b, h, s_q] float32.
// Instantiated for head_dim 64 and 128.

#include <cuda.h>  // CUtensorMap and its enums (no link against libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "launch_record.cuh"
#include "mma_bf16.cuh"

namespace {

using mma_bf16::cp_async16;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait_all;
using mma_bf16::cp_async_wait_prior;

constexpr int kRows = 64;      // rows of every tile (queries or keys)
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPStride = kRows + 16;  // float32 score tile row, padded
constexpr float kMaskFill = -1e30f;   // the plain version's masked logit

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// reductions over the 16 lanes of a half-warp (one score row)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);   // elements per 16 bytes
  static constexpr int kChunks = D / kVec;      // 16-byte pieces per row
  static constexpr int kStride = D + kVec;      // padded row, elements
  static constexpr int kElems = kRows * kStride;
};


// rows row0 .. row0 + 63 of a [n, D] matrix into a padded shared tile;
// rows past n are zero-filled (they must not hold NaN garbage)
template <typename T, int D, int NT = kThreads>
__device__ __forceinline__ void load_tile(T* tile, const T* g, int row0,
                                          int n) {
  using L = Tile<T, D>;
  for (int i = threadIdx.x; i < kRows * L::kChunks; i += NT) {
    const int r = i / L::kChunks;
    const int c = i - r * L::kChunks;
    const bool ok = row0 + r < n;
    const T* src = g + (size_t)(ok ? row0 + r : 0) * D + c * L::kVec;
    cp_async16(tile + r * L::kStride + c * L::kVec, src, ok ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores: 256 threads as a 16 x 16 grid; thread (ty, tx)
// owns score rows ty + 16i and columns tx + 16j (a 4 x 4 micro-tile) and
// output columns tx + 16c; row statistics reduce over the 16 lanes of a
// half-warp; probabilities pass through a float32 shared tile.

__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

// acc[i][j] += A[ra + 16i] . B[rb + 16j] over D: a 4 x 4 micro-tile of
// A B^T, both operands padded shared tiles
template <int D>
__device__ __forceinline__ void tile_abt(const float* A, int ra, const float* B,
                                         int rb, float (&acc)[4][4]) {
  using L = Tile<float, D>;
#pragma unroll 2
  for (int c = 0; c < L::kChunks; ++c) {
    float b[4][L::kVec];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      load16(B + (rb + 16 * j) * L::kStride + c * L::kVec, b[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a[L::kVec];
      load16(A + (ra + 16 * i) * L::kStride + c * L::kVec, a);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < L::kVec; ++e)
          acc[i][j] = fmaf(a[e], b[j][e], acc[i][j]);
    }
  }
}

// acc[i][c] += sum_r P[ra + 16i][r] * X[r][tx + 16c] over the 64 rows of X:
// a float32 score tile times a padded shared value tile
template <int D>
__device__ __forceinline__ void tile_px(const float* P, int ra, const float* X,
                                        int tx, float (&acc)[4][D / 16]) {
  using L = Tile<float, D>;
#pragma unroll 4
  for (int r = 0; r < kRows; ++r) {
    float x[D / 16];
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      x[c] = X[r * L::kStride + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = P[(ra + 16 * i) * kPStride + r];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] = fmaf(p, x[c], acc[i][c]);
    }
  }
}

// keys a causal query block [q0, q_last] needs: none past the diagonal of
// its last row; every key when one of its rows sees none (its reference
// output is then the mean of v)
__device__ __forceinline__ int keys_needed(int q0, int q_last, int s_k,
                                           int off, bool causal) {
  if (!causal || q0 + off < 0) return s_k;
  return min(s_k, q_last + off + 1);
}

template <int D>
struct FwdSmem32 {
  using L = Tile<float, D>;
  // q tile, two stages of (k, v) tiles, then the float32 probability tile
  static constexpr size_t kBytes =
      5 * L::kElems * sizeof(float) + kRows * kPStride * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int h, int s_q, int s_k,
                 float scale, int causal) {
  using L = Tile<float, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* kv_s = q_s + L::kElems;  // [stage][k, v][kRows][kStride]
  float* p_s = reinterpret_cast<float*>(kv_s + 4 * L::kElems);

  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest first
  const size_t bh = (size_t)blockIdx.z * h + blockIdx.y;
  const int off = s_k - s_q;
  const float* qg = q + bh * s_q * D;
  const float* kg = k + bh * s_k * D;
  const float* vg = v + bh * s_k * D;

  const int q_last = min(q0 + kRows, s_q) - 1;
  const int n_kv = keys_needed(q0, q_last, s_k, off, causal);
  const int n_tiles = (n_kv + kRows - 1) / kRows;

  load_tile<float, D>(q_s, qg, q0, s_q);
  load_tile<float, D>(kv_s, kg, 0, s_k);
  load_tile<float, D>(kv_s + L::kElems, vg, 0, s_k);
  cp_async_commit();

  float acc[4][D / 16];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      float* next = kv_s + ((t + 1) & 1) * 2 * L::kElems;
      load_tile<float, D>(next, kg, (t + 1) * kRows, s_k);
      load_tile<float, D>(next + L::kElems, vg, (t + 1) * kRows, s_k);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_prior();
    __syncthreads();
    const float* k_s = kv_s + (t & 1) * 2 * L::kElems;
    const float* v_s = k_s + L::kElems;
    const int j0 = t * kRows;

    float sc[4][4] = {};
    tile_abt<D>(q_s, ty, k_s, tx, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lim = q0 + ty + 16 * i + off;  // last key this row sees
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = j0 + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (col >= s_k)
          x = -INFINITY;  // no such key
        else if (causal && col > lim)
          x = kMaskFill;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // finite: key j0 < s_k is in this tile and scores at least -1e30
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        p_s[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the probability tile is complete
    tile_px<D>(p_s, ty, v_s, tx, acc);
    __syncthreads();  // p_s and stage t & 1 are free
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < s_q) {
      float* out = o + (bh * s_q + row) * D;
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        out[tx + 16 * c] = acc[i][c] / l[i];
      if (tx == 0) lse[bh * s_q + row] = m[i] + logf(l[i]);
    }
  }
}

// delta[row] = sum_d do[row][d] * o[row][d] in float32: one warp per row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* a = o + (size_t)row * D;
  const T* b = dout + (size_t)row * D;
  float s = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) s = fmaf(to_f32(a[c]), to_f32(b[c]), s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) delta[row] = s;
}

// p and dS of one (query row, key) pair, as the plain version's autograd
// gives them: masked pairs have p = 0 and no score gradient; a row that
// sees no key (causal, s_q > s_k) is uniform over every key
__device__ __forceinline__ void prob_and_ds(float score, float dp, int row,
                                            int key, int s_q, int s_k,
                                            int off, bool causal, float scale,
                                            float lse, float delta, float& p,
                                            float& ds) {
  if (row >= s_q || key >= s_k) {
    p = 0.f;
    ds = 0.f;
  } else if (causal && row + off < 0) {
    p = 1.f / (float)s_k;
    ds = 0.f;
  } else if (causal && key > row + off) {
    p = 0.f;
    ds = 0.f;
  } else {
    p = expf(score * scale - lse);
    ds = p * (dp - delta);
  }
}

template <int D>
struct DkdvSmem {
  using L = Tile<float, D>;
  // k, v, q, do tiles; P^T and dS^T tiles; lse and delta of 64 rows
  static constexpr size_t kBytes = 4 * L::kElems * sizeof(float) +
                                   2 * kRows * kPStride * sizeof(float) +
                                   2 * kRows * sizeof(float);
};

// one block per 64-key tile: dv = P^T do, dk = scale * dS^T q, summed over
// the query tiles that see the keys
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int h, int s_q, int s_k,
                      float scale, int causal) {
  using L = Tile<float, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + L::kElems;
  float* q_s = v_s + L::kElems;
  float* do_s = q_s + L::kElems;
  float* pt_s = reinterpret_cast<float*>(do_s + L::kElems);  // P^T
  float* dst_s = pt_s + kRows * kPStride;                    // dS^T
  float* lse_s = dst_s + kRows * kPStride;
  float* delta_s = lse_s + kRows;

  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int k0 = blockIdx.x * kRows;
  const size_t bh = (size_t)blockIdx.z * h + blockIdx.y;
  const int off = s_k - s_q;
  const float* qg = q + bh * s_q * D;
  const float* dog = dout + bh * s_q * D;

  load_tile<float, D>(k_s, k + bh * s_k * D, k0, s_k);
  load_tile<float, D>(v_s, v + bh * s_k * D, k0, s_k);
  cp_async_commit();

  // query rows i >= k0 - off see this tile; with s_q > s_k the rows that
  // see no key attend every key uniformly, so then all rows take part
  const int t_begin = (causal && off >= 0) ? max(0, k0 - off) / kRows : 0;
  const int n_q_tiles = (s_q + kRows - 1) / kRows;

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int t = t_begin; t < n_q_tiles; ++t) {
    const int q0 = t * kRows;
    load_tile<float, D>(q_s, qg, q0, s_q);
    load_tile<float, D>(do_s, dog, q0, s_q);
    cp_async_commit();
    if (threadIdx.x < kRows) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < s_q ? lse[bh * s_q + row] : 0.f;
      delta_s[threadIdx.x] = row < s_q ? delta[bh * s_q + row] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    float st[4][4] = {}, dpt[4][4] = {};
    tile_abt<D>(k_s, ty, q_s, tx, st);   // S^T: keys x queries
    tile_abt<D>(v_s, ty, do_s, tx, dpt); // dP^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        float p, ds;
        prob_and_ds(st[i][j], dpt[i][j], q0 + r, key, s_q, s_k, off,
                    causal, scale, lse_s[r], delta_s[r], p, ds);
        pt_s[(ty + 16 * i) * kPStride + r] = p;
        dst_s[(ty + 16 * i) * kPStride + r] = ds;
      }
    }
    __syncthreads();
    tile_px<D>(pt_s, ty, do_s, tx, dv_acc);
    tile_px<D>(dst_s, ty, q_s, tx, dk_acc);
    __syncthreads();  // q_s, do_s and the score tiles are free
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key < s_k) {
      const size_t base = (bh * s_k + key) * D;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        dk[base + tx + 16 * c] = dk_acc[i][c] * scale;
        dv[base + tx + 16 * c] = dv_acc[i][c];
      }
    }
  }
}

template <int D>
struct DqSmem {
  using L = Tile<float, D>;
  // q, do tiles, two stages of (k, v) tiles, the dS tile, lse and delta
  static constexpr size_t kBytes = 6 * L::kElems * sizeof(float) +
                                   kRows * kPStride * sizeof(float) +
                                   2 * kRows * sizeof(float);
};

// one block per 64-query tile: dq = scale * dS k over the key tiles it sees
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int h, int s_q, int s_k, float scale, int causal) {
  using L = Tile<float, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + L::kElems;
  float* kv_s = do_s + L::kElems;  // [stage][k, v][kRows][kStride]
  float* ds_s = reinterpret_cast<float*>(kv_s + 4 * L::kElems);
  float* lse_s = ds_s + kRows * kPStride;
  float* delta_s = lse_s + kRows;

  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest first
  const size_t bh = (size_t)blockIdx.z * h + blockIdx.y;
  const int off = s_k - s_q;
  const float* kg = k + bh * s_k * D;
  const float* vg = v + bh * s_k * D;

  // rows that see no key carry no score gradient, so only the keys left
  // of the last row's diagonal matter here
  const int q_last = min(q0 + kRows, s_q) - 1;
  const int n_kv = causal ? max(0, min(s_k, q_last + off + 1)) : s_k;
  const int n_tiles = (n_kv + kRows - 1) / kRows;

  load_tile<float, D>(q_s, q + bh * s_q * D, q0, s_q);
  load_tile<float, D>(do_s, dout + bh * s_q * D, q0, s_q);
  if (n_tiles > 0) {
    load_tile<float, D>(kv_s, kg, 0, s_k);
    load_tile<float, D>(kv_s + L::kElems, vg, 0, s_k);
  }
  cp_async_commit();
  if (threadIdx.x < kRows) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < s_q ? lse[bh * s_q + row] : 0.f;
    delta_s[threadIdx.x] = row < s_q ? delta[bh * s_q + row] : 0.f;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      float* next = kv_s + ((t + 1) & 1) * 2 * L::kElems;
      load_tile<float, D>(next, kg, (t + 1) * kRows, s_k);
      load_tile<float, D>(next + L::kElems, vg, (t + 1) * kRows, s_k);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const float* k_s = kv_s + (t & 1) * 2 * L::kElems;
    const float* v_s = k_s + L::kElems;
    const int j0 = t * kRows;

    float s[4][4] = {}, dp[4][4] = {};
    tile_abt<D>(q_s, ty, k_s, tx, s);
    tile_abt<D>(do_s, ty, v_s, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p, ds;
        prob_and_ds(s[i][j], dp[i][j], q0 + r, j0 + tx + 16 * j, s_q, s_k,
                    off, causal, scale, lse_s[r], delta_s[r], p, ds);
        ds_s[r * kPStride + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    tile_px<D>(ds_s, ty, k_s, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < s_q) {
      float* out = dq + (bh * s_q + row) * D;
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        out[tx + 16 * c] = acc[i][c] * scale;
    }
  }
}


using mma_bf16::bf16;
using mma_bf16::quad_max;
using mma_bf16::quad_sum;

// a kernel launch with its dynamic shared memory; returns the launch error
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, int threads,
                   size_t smem, cudaStream_t stream, Args... args) {
  if (launch_record::note(grid, threads, smem)) return cudaSuccess;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 backward on Hopper: TMA, mbarriers, wgmma.
//
// A block owns 64 keys of one (batch, head) and walks the query tiles that
// see them. Warp 4 is the producer: it loads the block's K and V tiles once
// and then, for each query tile, the q and do tiles (TMA, 128-byte
// swizzle, rows past s_q zero-filled by the hardware) and the tile's lse
// and delta (one bulk copy from the prep kernel's padded copy) into a ring
// of kBwdStages stages, each tracked by a full and an empty mbarrier.
// Warps 0-3 are one consumer warpgroup; per query tile they run five
// products on wgmma with K and V resident in shared memory:
//   S^T  = K q^T          dP^T = V do^T        (A, B from shared memory)
//   dV  += P^T do         dK  += dS^T q        (A = P^T, dS^T from registers)
//   dQ^T = K^T dS^T       (dS^T through shared memory, D / 64 slices)
// and add dQ into a float32 buffer with one bulk reduce-add per tile
// (cp.reduce.async.bulk .add.f32), which a last kernel scales and rounds
// to bf16. Blocks of different key tiles add into the same dQ rows in no
// fixed order, so dq changes between runs by float32 reassociation before
// its one bf16 rounding (dk and dv do not).

constexpr int kBwdRows = 64;      // keys per block, queries per tile
constexpr int kBwdStages = 2;     // q / do / statistics ring
constexpr int kBwdThreads = 160;  // a consumer warpgroup + a producer warp

template <int D>
struct BwdSmem {
  // a 64 x D bf16 tile is D / 64 column blocks of 64 rows x 128 bytes
  // (128-byte swizzle), as TMA writes it and wgmma reads it
  static constexpr int kTile = kBwdRows * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kQ = kV + kTile;                  // [stage]
  static constexpr int kDo = kQ + kBwdStages * kTile;    // [stage]
  static constexpr int kDs = kDo + kBwdStages * kTile;   // dS^T [key][query]
  static constexpr int kDq = kDs + kBwdRows * kBwdRows * 2;  // f32 [q][D]
  static constexpr int kStats = kDq + kBwdRows * D * 4;  // [stage][2][64]
  static constexpr int kBars = kStats + kBwdStages * 2 * kBwdRows * 4;
  // full[stage], empty[stage], kv; then room to align the base to 1024
  static constexpr int kAlloc = kBars + (2 * kBwdStages + 1) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed; a wait that never
// ends (a fault in the pipeline) traps, so the launch fails instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read_all() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy shared-memory writes visible to the async proxy (wgmma,
// bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of the consumer warpgroup alone (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// until at most one committed group is in flight
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from moving accesses to accumulator registers across
// the asynchronous products, and from reusing the registers of an A
// operand before the product that reads them has completed
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int K>
__device__ __forceinline__ void fence_regs(unsigned (&r)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// shared-memory matrix descriptor of a 128-byte-swizzled operand
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// k-step ks (16 columns) of a 64 x D tile read K-major: column block
// ks / 4, 32 bytes into the swizzled row per step
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ks) {
  return sw128_desc(tile + (ks >> 2) * (kBwdRows * 128) + (ks & 3) * 32, 16,
                    1024);
}

// k-step kk (16 rows) of a 64-row tile read MN-major (the columns are the
// product's M or N): 16 rows of 128 bytes per step, column blocks
// kBwdRows * 128 bytes apart
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, kBwdRows * 128, 1024);
}

// d (64 x 64, float32) = [d +] A B, A and B from shared memory through
// their descriptors; TA / TB: 1 = that operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x 64, float32) [+]= A B, A (64 x 16 bf16) from registers in the
// accumulator layout, B from shared memory; TB: 1 = B is MN-major
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const unsigned (&a)[4],
                                             uint64_t b,
                                             int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TB));
}

// d (64 x 128, float32) += A B, A (64 x 16 bf16) from registers in the
// accumulator layout, B from shared memory; TB: 1 = B is MN-major
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const unsigned (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}


template <int D>
__device__ __forceinline__ void wgmma_rs_nd(float (&d)[D / 2],
                                            const unsigned (&a)[4],
                                            uint64_t b) {
  if constexpr (D == 64)
    wgmma_rs_n64<1>(d, a, b);
  else
    wgmma_rs_n128<1>(d, a, b);
}

constexpr float kLog2e = 1.4426950408889634f;

// P^T and dS^T of one tile in place, from the S^T and dP^T accumulators:
// register 4 j + 2 hh + e is key row key0 + 8 hh, query column
// q0 + 8 j + 2 t + e. p = exp2(s * scale log2 e - lse log2 e) (the prep
// kernel stores lse times log2 e), ds = p (dp - delta). kMasked: the
// masks of prob_and_ds (pairs outside the shapes or above the diagonal
// get p = ds = 0; a row that sees no key is uniform with no gradient)
template <bool kMasked>
__device__ __forceinline__ void probs_and_ds(
    float (&s_acc)[32], float (&dp_acc)[32], const float* lse_s,
    const float* delta_s, int q0, int key0, int t, int s_q, int s_k, int off,
    int causal, float scale_l2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t + e;
      const float lse_l2 = lse_s[c];
      const float delta = delta_s[c];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int reg = 4 * j + 2 * hh + e;
        float p = exp2f(fmaf(s_acc[reg], scale_l2, -lse_l2));
        float ds = p * (dp_acc[reg] - delta);
        if constexpr (kMasked) {
          const int row = q0 + c, key = key0 + 8 * hh;
          if (row >= s_q || key >= s_k || (causal && key > row + off)) {
            p = ds = 0.f;
          }
          if (causal && row + off < 0 && row < s_q && key < s_k) {
            p = 1.f / (float)s_k;  // sees no key: uniform over every key
            ds = 0.f;
          }
        }
        s_acc[reg] = p;
        dp_acc[reg] = ds;
      }
    }
}

// one warp per padded query row r < n_q_tiles * 64 of each (batch, head):
// delta = rowsum(do * o) and lse log2 e into stats
// [bh][tile][lse, delta][64] (0 past s_q), and the row's float32 dq
// accumulator set to 0
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_kernel(const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ stats,
                      float* __restrict__ dq_acc, int s_q, int n_q_tiles,
                      int padded_rows) {
  const int idx = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (idx >= padded_rows) return;
  const int bh = idx / (n_q_tiles * kBwdRows);
  const int r = idx - bh * n_q_tiles * kBwdRows;
  float dl = 0.f, ls = 0.f;
  if (r < s_q) {
    const size_t row = (size_t)bh * s_q + r;
    const bf16* a = o + row * D;
    const bf16* b = dout + row * D;
#pragma unroll
    for (int c = lane; c < D; c += 32)
      dl = fmaf(to_f32(a[c]), to_f32(b[c]), dl);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) dl += __shfl_xor_sync(0xffffffffu, dl, w);
    ls = lse[row] * kLog2e;
#pragma unroll
    for (int c = lane; c < D; c += 32) dq_acc[row * D + c] = 0.f;
  }
  if (lane == 0) {
    float* st = stats + ((size_t)bh * n_q_tiles + r / kBwdRows) * 2 * kBwdRows;
    st[r % kBwdRows] = ls;
    st[kBwdRows + r % kBwdRows] = dl;
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, D == 64 ? 2 : 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ stats,
                       float* __restrict__ dq_acc, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int h, int s_q, int s_k,
                       float scale, int causal) {
  using L = BwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* smem = smem_raw + (sbase - raw);
  const uint32_t kv_bar = sbase + L::kBars + 2 * kBwdStages * 8;
  auto full = [&](int st) { return sbase + L::kBars + st * 8; };
  auto empty = [&](int st) { return sbase + L::kBars + (kBwdStages + st) * 8; };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kBwdRows;
  const int bh = blockIdx.z * h + blockIdx.y;
  const int off = s_k - s_q;
  const int n_q_tiles = (s_q + kBwdRows - 1) / kBwdRows;
  // query rows i >= k0 - off see this tile; with s_q > s_k the rows that
  // see no key attend every key uniformly, so then all rows take part
  const int t_begin =
      (causal && off >= 0) ? max(0, k0 - off) / kBwdRows : 0;
  const int n_tiles = n_q_tiles - t_begin;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 128);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * L::kTile);
      for (int cb = 0; cb < D / 64; ++cb) {
        tma_load_3d(sbase + L::kK + cb * kBwdRows * 128, &map_k, cb * 64, k0,
                    bh, kv_bar);
        tma_load_3d(sbase + L::kV + cb * kBwdRows * 128, &map_v, cb * 64, k0,
                    bh, kv_bar);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kBwdStages;
        mbar_wait(empty(st), ((i / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * L::kTile + 2 * kBwdRows * 4);
        const int tile = t_begin + i;
        for (int cb = 0; cb < D / 64; ++cb) {
          const uint32_t at = st * L::kTile + cb * kBwdRows * 128;
          tma_load_3d(sbase + L::kQ + at, &map_q, cb * 64, tile * kBwdRows,
                      bh, full(st));
          tma_load_3d(sbase + L::kDo + at, &map_do, cb * 64,
                      tile * kBwdRows, bh, full(st));
        }
        bulk_load(sbase + L::kStats + st * 2 * kBwdRows * 4,
                  stats + ((size_t)bh * n_q_tiles + tile) * 2 * kBwdRows,
                  2 * kBwdRows * 4, full(st));
      }
    }
    return;
  }

  // the consumer warpgroup: thread (warp, g, t) holds keys
  // k0 + 16 warp + g (+ 8) of every accumulator whose rows are keys
  const int tid = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  const int key_row = warp * 16 + g;  // + 8 for the second half
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float* dq_s = reinterpret_cast<float*>(smem + L::kDq);
  const float scale_l2 = scale * kLog2e;  // exp(x) = exp2(x log2 e)
  mbar_wait(kv_bar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kBwdStages;
    const int q0 = (t_begin + i) * kBwdRows;
    const uint32_t q_t = sbase + L::kQ + st * L::kTile;
    const uint32_t do_t = sbase + L::kDo + st * L::kTile;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + L::kStats + st * 2 * kBwdRows * 4);
    const float* delta_s = lse_s + kBwdRows;
    mbar_wait(full(st), (i / kBwdStages) & 1);

    // S^T = K q^T, dP^T = V do^T (keys x queries)
    float s_acc[32], dp_acc[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64<0, 0>(s_acc, kmajor<D>(sbase + L::kK, ks),
                         kmajor<D>(q_t, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64<0, 0>(dp_acc, kmajor<D>(sbase + L::kV, ks),
                         kmajor<D>(do_t, ks), ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s_acc);
    fence_regs(dp_acc);

    // P^T and dS^T in place; a tile wholly inside the visible region (every
    // query < s_q sees every key < s_k of the block) needs no mask
    if (q0 + kBwdRows <= s_q && k0 + kBwdRows <= s_k &&
        (!causal || k0 + kBwdRows - 1 <= q0 + off))
      probs_and_ds<false>(s_acc, dp_acc, lse_s, delta_s, q0, k0 + key_row, t,
                          s_q, s_k, off, causal, scale_l2);
    else
      probs_and_ds<true>(s_acc, dp_acc, lse_s, delta_s, q0, k0 + key_row, t,
                         s_q, s_k, off, causal, scale_l2);
    // as bf16 A operands over the query columns, 16 per k-step
    unsigned pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = mma_bf16::pack_bf16(s_acc[8 * kk + 2 * r],
                                        s_acc[8 * kk + 2 * r + 1]);
        da[kk][r] = mma_bf16::pack_bf16(dp_acc[8 * kk + 2 * r],
                                        dp_acc[8 * kk + 2 * r + 1]);
      }

    // dV += P^T do, dK += dS^T q
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_nd<D>(dv_acc, pa[kk], mnmajor(do_t, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_nd<D>(dk_acc, da[kk], mnmajor(q_t, kk));
    wgmma_commit();

    // dS^T to shared memory ([key][query], 128-byte swizzle) for dQ, once
    // the last tile's dQ product has read it and its bulk reduce-add has
    // read the dQ buffer; da[kk][r] holds key row key_row + 8 (r & 1),
    // columns 16 kk + 8 (r >> 1) + 2 t, + 1
    if (tid == 0) bulk_wait_read_all();
    consumer_sync();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = key_row + 8 * (r & 1);
        const int chunk = 2 * kk + (r >> 1);
        *reinterpret_cast<unsigned*>(smem + L::kDs + row * 128 +
                                     ((chunk ^ (row & 7)) << 4) + 4 * t) =
            da[kk][r];
      }
    fence_proxy_async();
    consumer_sync();

    // dQ^T = K^T dS^T, 64 rows of D at a time: rows are head dims, columns
    // queries; into dq_s [query][D]
#pragma unroll
    for (int sl = 0; sl < D / 64; ++sl) {
      float dq_t[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64<1, 1>(dq_t,
                           mnmajor(sbase + L::kK + sl * kBwdRows * 128, kk),
                           mnmajor(sbase + L::kDs, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();  // and the dK / dV products
      fence_regs(dq_t);
      fence_regs(pa);  // their A operands stay untouched until here
      fence_regs(da);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            dq_s[(8 * j + 2 * t + e) * D + sl * 64 + key_row + 8 * hh] =
                dq_t[4 * j + 2 * hh + e];
    }
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    mbar_arrive(empty(st));  // q, do and the statistics are read
    fence_proxy_async();
    consumer_sync();
    if (tid == 0) {
      const int rows = min(kBwdRows, s_q - q0);
      bulk_reduce_add(dq_acc + ((size_t)bh * s_q + q0) * D, sbase + L::kDq,
                      rows * D * 4);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + key_row + 8 * hh;
    if (key >= s_k) continue;
    bf16* dk_row = dk + ((size_t)bh * s_k + key) * D + 2 * t;
    bf16* dv_row = dv + ((size_t)bh * s_k + key) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk_row + 8 * j) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * hh] * scale,
                                dk_acc[4 * j + 2 * hh + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_row + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * hh],
                                dv_acc[4 * j + 2 * hh + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 forward on Hopper: TMA, mbarriers, wgmma, a persistent grid.
//
// A work item is 128 queries of one (batch, head). A grid of one block an
// SM walks units of two items of one head, the i-th query block from the
// end and the i-th from the start (fwd_next_item), so that every block
// gets about the same causal work. A block is two consumer warpgroups of
// 64 query rows each (warps 0-7) and a producer warpgroup (warps 8-11)
// whose first thread issues every copy. For each item the producer loads
// the q tile once (into a buffer the consumers release as soon as they
// hold q: in registers at head_dim 64, after their last S product at 128)
// and then keeps the item's K and V tiles in flight in a ring of
// kFwdStages stages, each tracked by a full and an empty mbarrier that
// every consumer warp arrives on once (TMA, 128-byte swizzle, the
// backward's 64 x 64 boxes; rows past s_q or s_k zero-filled by the
// hardware). The ring runs on from one item into the next, so the next
// item's q and first tiles arrive while this one's last tiles and
// epilogue run. Per tile a consumer warpgroup runs two products on wgmma:
//   S  = q K^T   (K K-major from shared memory; q from registers at
//                 head_dim 64, K-major from shared memory at 128)
//   O += P V     (P from registers in the accumulator layout, V MN-major)
// with the online softmax in registers between them, in log2 units (m is
// the running max of s * scale * log2 e); tile i's S product and tile
// i - 1's P V are in flight together. A tile wholly inside the visible
// region takes one exp2(fma(s, scale log2 e, -m)) an element and no
// branch; the diagonal tiles and the s_k tail take the masked path. The
// epilogue scales O by 1 / l, rounds it once to bf16 into the group's
// staging tile and stores it with one TMA store, which clips rows past
// s_q; the store runs on while the next item starts.

constexpr int kFwdRows = 128;      // queries per work item
constexpr int kFwdGroupRows = 64;  // queries per consumer warpgroup
constexpr int kFwdKeys = 64;       // keys per K/V tile
constexpr int kFwdStages = 4;      // K / V ring
constexpr int kFwdThreads = 384;   // two consumer warpgroups + a producer one
constexpr int kFwdConsumerWarps = 8;
// registers a thread after setmaxnreg: the block starts at 168 (65,536 /
// 384, rounded down to a multiple of 8); the producer gives up all but 40
// and the consumers may take 232 (2 x 128 x 232 + 128 x 40 = 64,512)
constexpr int kFwdProducerRegs = 40;
constexpr int kFwdConsumerRegs = 232;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMaskL2 = kMaskFill * kLog2e;  // a masked logit, log2 units

template <int D>
struct FwdSmem {
  static constexpr int kQTile = kFwdGroupRows * D * 2;  // a group's q or o
  static constexpr int kKvTile = kFwdKeys * D * 2;
  static constexpr int kQ = 0;                          // [group]
  static constexpr int kO = kQ + 2 * kQTile;            // [group]
  static constexpr int kK = kO + 2 * kQTile;            // [stage]
  static constexpr int kV = kK + kFwdStages * kKvTile;  // [stage]
  static constexpr int kBars = kV + kFwdStages * kKvTile;
  // full[stage], empty[stage], q full, q empty; then room to align the
  // base to 1024
  static constexpr int kAlloc = kBars + (2 * kFwdStages + 2) * 8 + 1024;
};

// k-step ks (16 columns) of a 64 x D tile read K-major: D / 64 column
// blocks of 64 rows x 128 bytes
__device__ __forceinline__ uint64_t kmajor64(uint32_t tile, int ks) {
  return sw128_desc(tile + (ks >> 2) * (64 * 128) + (ks & 3) * 32, 16, 1024);
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a barrier of one consumer warpgroup (1 + group; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
}

// one arrival a warp on an mbarrier whose count is the consumer warps:
// after a wgmma wait every lane of the warp is past its products' reads
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// 2^x on the special-function unit, results below 2^-126 flushed to 0
// (beside the row's largest probability, 1, such a term is lost to the
// float32 sums anyway)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// K/V tiles that the query rows [r0, r0 + 64) visit: every key a row below
// s_q needs (keys_needed), none when no row is below s_q
__device__ __forceinline__ int fwd_tiles(int r0, int s_q, int s_k, int off,
                                         int causal) {
  if (r0 >= s_q) return 0;
  const int n = keys_needed(r0, min(r0 + kFwdGroupRows, s_q) - 1, s_k, off,
                            causal);
  return (n + kFwdKeys - 1) / kFwdKeys;
}

// one tile's scores to probabilities in place. Register 4 j + 2 hh + e is
// query row row0 + 8 hh, key j0 + 8 j + 2 t + e. m (log2 units) and this
// thread's part of l are the running max and sum of its two rows; alpha
// the factor on their old O. kMasked: a key past s_k scores -inf and a key
// past a causal row's diagonal -1e30 after scaling (a row that sees no key
// is then uniform over every key, as in the plain version); without it
// every pair is visible and each element costs one exp2 and one fma
template <bool kMasked>
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2], int row0,
                                               int j0, int t, int s_k,
                                               int off, int causal,
                                               float scale_l2) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int reg = 4 * j + 2 * hh + e;
        if constexpr (kMasked) {
          const int key = j0 + 8 * j + 2 * t + e;
          float x = s[reg] * scale_l2;
          if (key >= s_k)
            x = -INFINITY;  // no such key
          else if (causal && key > row0 + 8 * hh + off)
            x = kMaskL2;
          s[reg] = x;
        }
        mx = fmaxf(mx, s[reg]);
      }
    if constexpr (!kMasked) mx *= scale_l2;  // the mask-free path has scale > 0
    // finite: the tile holds key j0 < s_k, which scores at least kMaskL2
    const float m_new = fmaxf(m[hh], quad_max(mx));
    alpha[hh] = exp2_ftz(m[hh] - m_new);  // 0 on the first tile
    m[hh] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int reg = 4 * j + 2 * hh + e;
        const float p = kMasked ? exp2_ftz(s[reg] - m_new)
                                : exp2_ftz(fmaf(s[reg], scale_l2, -m_new));
        s[reg] = p;
        sum += p;
      }
    l[hh] = l[hh] * alpha[hh] + sum;
  }
}

// what the softmax of a consumer thread needs of its rows and the shapes
struct FwdRows {
  int r0, row0, t, s_q, s_k, off, causal;
  float scale, scale_l2;
};

// the tile at key j0: the mask-free path when every query of the group
// below s_q sees every key of the tile, else the masked one
__device__ __forceinline__ void fwd_softmax(float (&s_acc)[32], float (&m)[2],
                                            float (&l)[2], float (&alpha)[2],
                                            int j0, const FwdRows& r) {
  if (r.r0 + kFwdGroupRows <= r.s_q && j0 + kFwdKeys <= r.s_k &&
      r.scale > 0.f && (!r.causal || j0 + kFwdKeys - 1 <= r.r0 + r.off))
    online_softmax<false>(s_acc, m, l, alpha, r.row0, j0, r.t, r.s_k, r.off,
                          r.causal, r.scale_l2);
  else
    online_softmax<true>(s_acc, m, l, alpha, r.row0, j0, r.t, r.s_k, r.off,
                         r.causal, r.scale_l2);
}

// q as A operands in registers at head_dim 64 (16 a thread): the S
// product then reads only K from shared memory, which halves its shared
// memory traffic; at 128 the 32 registers would not fit beside O
template <int D>
constexpr bool kFwdQInRegs = D == 64;
template <int D>  // k-steps of q held in registers
constexpr int kFwdQSteps = kFwdQInRegs<D> ? D / 16 : 1;

// the group's q tile (64 x D, 128-byte swizzle) as A operands, 16 columns
// a k-step: a[ks][r] holds row 16 w + g + 8 (r & 1), columns
// 16 ks + 8 (r >> 1) + 2 t, + 1, as the accumulator layout places them
template <int D>
__device__ __forceinline__ void load_q_frags(unsigned (&a)[kFwdQSteps<D>][4],
                                             const unsigned char* q_s,
                                             int row, int t) {
#pragma unroll
  for (int ks = 0; ks < kFwdQSteps<D>; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int rr = row + 8 * (r & 1);
      const int chunk = 2 * (ks & 3) + (r >> 1);
      a[ks][r] = *reinterpret_cast<const unsigned*>(
          q_s + (ks >> 2) * (kFwdGroupRows * 128) + rr * 128 +
          ((chunk ^ (rr & 7)) << 4) + 4 * t);
    }
}

// the scores of one tile into s_acc (64 x 64), as one committed group: q
// from registers (q_a) or from shared memory (q_t)
template <int D>
__device__ __forceinline__ void fwd_scores(
    float (&s_acc)[32], const unsigned (&q_a)[kFwdQSteps<D>][4], uint32_t q_t,
    uint32_t k_t) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    if constexpr (kFwdQInRegs<D>)
      wgmma_rs_n64<0>(s_acc, q_a[ks % kFwdQSteps<D>], kmajor64(k_t, ks),
                      ks > 0);
    else
      wgmma_ss_n64<0, 0>(s_acc, kmajor64(q_t, ks), kmajor64(k_t, ks), ks > 0);
  }
  wgmma_commit();
}

// O += P V over one tile, as one committed group
template <int D>
__device__ __forceinline__ void fwd_pv(float (&o_acc)[D / 2],
                                       const unsigned (&pa)[4][4],
                                       uint32_t v_t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_nd<D>(o_acc, pa[kk], mnmajor(v_t, kk));
  wgmma_commit();
}

// probabilities as bf16 A operands over the keys, 16 per k-step
__device__ __forceinline__ void pack_probs(unsigned (&pa)[4][4],
                                           const float (&s_acc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = mma_bf16::pack_bf16(s_acc[8 * kk + 2 * r],
                                      s_acc[8 * kk + 2 * r + 1]);
}

// The work of one block: units of two query blocks (work items) of one
// (batch, head), the i-th from the end and the i-th from the start, whose
// causal work sums to about the same for every unit of a square shape;
// units in (batch, head) order, block j taking units j, j + grid, ... So
// every block gets about the same work, the heavier item of a unit
// first, and the blocks running at one time share a few heads' K and V
// in L2. fwd_next_item moves k to the block's next item and gives its
// first query and (batch, head); false when the block has no more.
__device__ __forceinline__ bool fwd_next_item(int& k, int bh_count,
                                              int n_qblocks, int& q0,
                                              int& bh) {
  const int n_pairs = (n_qblocks + 1) / 2;
  for (;; ++k) {
    const long long unit = blockIdx.x + (long long)(k >> 1) * gridDim.x;
    if (unit >= (long long)bh_count * n_pairs) return false;
    const int p = (int)(unit % n_pairs);
    const int qb = (k & 1) ? p : n_qblocks - 1 - p;
    if ((k & 1) && qb == n_qblocks - 1 - p) continue;  // an odd count's middle
    bh = (int)(unit / n_pairs);
    q0 = qb * kFwdRows;
    ++k;
    return true;
  }
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_o,
                       float* __restrict__ lse, int bh_count, int s_q,
                       int s_k, float scale, int causal) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* smem = smem_raw + (sbase - raw);
  const uint32_t q_full = sbase + L::kBars + 2 * kFwdStages * 8;
  const uint32_t q_empty = q_full + 8;
  const auto full = [&](int st) { return sbase + L::kBars + st * 8; };
  const auto empty = [&](int st) {
    return sbase + L::kBars + (kFwdStages + st) * 8;
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int off = s_k - s_q;
  const int n_qblocks = (s_q + kFwdRows - 1) / kFwdRows;
  // the item's tiles: those of its second group, or of its first when
  // that one sees every key or the second has no rows
  const auto item_tiles = [&](int q0) {
    return max(fwd_tiles(q0, s_q, s_k, off, causal),
               fwd_tiles(q0 + kFwdGroupRows, s_q, s_k, off, causal));
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kFwdStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kFwdConsumerWarps);  // one arrival a warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kFwdConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kFwdConsumerWarps) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kFwdProducerRegs));
    if (warp == kFwdConsumerWarps && lane == 0) {
      int it = 0;  // tiles loaded so far: the ring position
      int q0, bh;
      for (int k = 0, n = 0; fwd_next_item(k, bh_count, n_qblocks, q0, bh);
           ++n) {
        const int n_tiles = item_tiles(q0);
        mbar_wait(q_empty, (n & 1) ^ 1);  // the last item's S products ran
        mbar_expect_tx(q_full, 2 * L::kQTile);
        for (int grp = 0; grp < 2; ++grp)
          for (int cb = 0; cb < D / 64; ++cb)
            tma_load_3d(sbase + L::kQ + grp * L::kQTile + cb * 64 * 128,
                        &map_q, cb * 64, q0 + grp * kFwdGroupRows, bh, q_full);
        for (int i = 0; i < n_tiles; ++i, ++it) {
          const int st = it % kFwdStages;
          mbar_wait(empty(st), ((it / kFwdStages) & 1) ^ 1);
          mbar_expect_tx(full(st), 2 * L::kKvTile);
          for (int cb = 0; cb < D / 64; ++cb) {
            const uint32_t at = st * L::kKvTile + cb * kFwdKeys * 128;
            tma_load_3d(sbase + L::kK + at, &map_k, cb * 64, i * kFwdKeys, bh,
                        full(st));
            tma_load_3d(sbase + L::kV + at, &map_v, cb * 64, i * kFwdKeys, bh,
                        full(st));
          }
        }
      }
    }
    return;
  }

  // a consumer: group grp, thread (w, g, t) holds query rows
  // r0 + 16 w + g (+ 8) of every accumulator
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kFwdConsumerRegs));
  const int grp = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;  // issues the group's stores
  const uint32_t q_t = sbase + L::kQ + grp * L::kQTile;
  const uint32_t o_t = sbase + L::kO + grp * L::kQTile;
  const float scale_l2 = scale * kLog2e;  // exp(x) = exp2(x log2 e)
  const auto wait_full = [&](int it) {
    mbar_wait(full(it % kFwdStages), (it / kFwdStages) & 1);
  };
  const auto k_tile = [&](int it) {
    return sbase + L::kK + (it % kFwdStages) * L::kKvTile;
  };
  const auto v_tile = [&](int it) {
    return sbase + L::kV + (it % kFwdStages) * L::kKvTile;
  };

  int it = 0;  // the ring position of the item's first tile
  int q0, bh;
  for (int k = 0, n = 0; fwd_next_item(k, bh_count, n_qblocks, q0, bh); ++n) {
    const int n_tiles = item_tiles(q0);
    const int r0 = q0 + grp * kFwdGroupRows;
    const int row0 = r0 + 16 * (warp & 3) + g;
    const int my_tiles = fwd_tiles(r0, s_q, s_k, off, causal);
    const FwdRows rows{r0, row0, t, s_q, s_k, off, causal, scale, scale_l2};
    float o_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, n & 1);
    unsigned q_a[kFwdQSteps<D>][4];
    if constexpr (kFwdQInRegs<D>) {
      load_q_frags<D>(q_a, smem + L::kQ + grp * L::kQTile, row0 - r0, t);
      warp_arrive(q_empty);  // q is in registers
    }

    // the products of one tile overlap the softmax of the next: tile i's
    // S product and tile i - 1's P V are issued together, and the P V runs
    // on while tile i's softmax does (a tile this group does not need is
    // still waited for and released: the ring's empty barrier counts both
    // groups)
    if (my_tiles > 0) {
      float s_acc[32];
      unsigned pa[4][4];
      float alpha[2];
      wait_full(it);
      wgmma_fence();
      fwd_scores<D>(s_acc, q_a, q_t, k_tile(it));
      wgmma_wait_all();
      fence_regs(s_acc);
      if (!kFwdQInRegs<D> && my_tiles == 1) warp_arrive(q_empty);  // q read
      fwd_softmax(s_acc, m, l, alpha, 0, rows);  // O is 0: no rescale
      pack_probs(pa, s_acc);
      for (int i = 1; i < my_tiles; ++i) {
        wait_full(it + i);
        fence_regs(o_acc);
        wgmma_fence();
        fwd_scores<D>(s_acc, q_a, q_t, k_tile(it + i));
        fwd_pv<D>(o_acc, pa, v_tile(it + i - 1));
        wgmma_wait_one();  // the scores; P V may still run
        fence_regs(s_acc);
        if (!kFwdQInRegs<D> && i == my_tiles - 1)
          warp_arrive(q_empty);  // q is read
        fwd_softmax(s_acc, m, l, alpha, i * kFwdKeys, rows);
        wgmma_wait_all();
        fence_regs(o_acc);
        fence_regs(pa);  // the A operands stay untouched until here
        warp_arrive(empty((it + i - 1) % kFwdStages));  // K, V read
#pragma unroll
        for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
          for (int r = 0; r < 4; ++r) o_acc[4 * nn + r] *= alpha[r >> 1];
        pack_probs(pa, s_acc);
      }
      fence_regs(o_acc);
      wgmma_fence();
      fwd_pv<D>(o_acc, pa, v_tile(it + my_tiles - 1));
      wgmma_wait_all();
      fence_regs(o_acc);
      fence_regs(pa);
      warp_arrive(empty((it + my_tiles - 1) % kFwdStages));
    } else if (!kFwdQInRegs<D>) {
      warp_arrive(q_empty);  // no row below s_q: q is not read
    }
    for (int i = my_tiles; i < n_tiles; ++i) {
      wait_full(it + i);
      warp_arrive(empty((it + i) % kFwdStages));
    }
    it += n_tiles;
    if (my_tiles == 0) continue;

    // lse = m ln 2 + log l (natural log; -1e30 + log l for a row that sees
    // no key, as the plain version's masked logits give it)
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float l_row = quad_sum(l[hh]);
      inv[hh] = 1.f / l_row;
      const int row = row0 + 8 * hh;
      if (t == 0 && row < s_q)
        lse[(size_t)bh * s_q + row] =
            (m[hh] == kMaskL2 ? kMaskFill : m[hh] * kLn2) + logf(l_row);
    }
    // O / l in bf16 into the group's staging tile, once the last item's
    // store has read it: 128-byte swizzle, D / 64 column blocks of 64 rows
    // x 128 bytes, as the TMA store reads it
    if (leader) bulk_wait_read_all();
    group_sync(grp);
    unsigned char* o_s = smem + L::kO + grp * L::kQTile;
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row0 + 8 * hh - r0;
        *reinterpret_cast<unsigned*>(o_s + (nn >> 3) * kFwdGroupRows * 128 +
                                     r * 128 + (((nn & 7) ^ (r & 7)) << 4) +
                                     4 * t) =
            mma_bf16::pack_bf16(o_acc[4 * nn + 2 * hh] * inv[hh],
                                o_acc[4 * nn + 2 * hh + 1] * inv[hh]);
      }
    fence_proxy_async();
    group_sync(grp);
    if (leader) {
      for (int cb = 0; cb < D / 64; ++cb)
        tma_store_3d(&map_o, o_t + cb * kFwdGroupRows * 128, cb * 64, r0, bh);
      bulk_commit();
    }
  }
  if (leader) bulk_wait_all();
}

// dq = scale * dq_acc, rounded once to bf16; four elements a thread
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_round_kernel(const float4* __restrict__ dq_acc,
                          __nv_bfloat162* __restrict__ dq, size_t n4,
                          float scale) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  const float4 x = dq_acc[i];
  dq[2 * i] = __floats2bfloat162_rn(x.x * scale, x.y * scale);
  dq[2 * i + 1] = __floats2bfloat162_rn(x.z * scale, x.w * scale);
}

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a map over [bh, rows, D] bf16 in boxes of 64 rows x 64 columns, 128-byte
// swizzle, rows past `rows` read as zeros (and clipped when stored). Every
// map here has that box and swizzle, the forward's and the backward's
// alike (a 128-key tile is two boxes), so a map is a function of the
// pointer and the shape alone and one kept for the forward serves the
// backward on the same tensor. The last few are kept and reused: the
// training step passes the same buffers step after step (four maps a
// layer each way), and encoding costs host time on a busy step.
bool make_map(CUtensorMap* map, const void* base, int bh, int rows, int d) {
  struct Entry {
    const void* base;
    int bh, rows, d;
    CUtensorMap map;
  };
  constexpr int kSlots = 256;
  static Entry cache[kSlots];
  static std::mutex mutex;  // ctypes calls drop the interpreter lock
  const size_t slot =
      ((reinterpret_cast<uintptr_t>(base) >> 8) ^ (size_t)rows * 131 ^
       (size_t)bh * 17) % kSlots;
  std::lock_guard<std::mutex> lock(mutex);
  Entry& e = cache[slot];
  if (e.base == base && e.bh == bh && e.rows == rows && e.d == d) {
    *map = e.map;
    return true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    e.base = nullptr;
    return false;
  }
  e.base = base;
  e.bh = bh;
  e.rows = rows;
  e.d = d;
  *map = e.map;
  return true;
}

// the SM count of the current device, read once per device
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

template <int D>
cudaError_t launch_forward_bf16(const void* q, const void* k, const void* v,
                                void* o, float* lse, int b, int h, int s_q,
                                int s_k, float scale, int causal,
                                cudaStream_t stream) {
  const int bh = b * h;
  CUtensorMap map_q, map_k, map_v, map_o;
  // a geometry query launches nothing, so it encodes no tensor map
  if (!launch_record::current() &&
      (!make_map(&map_q, q, bh, s_q, D) || !make_map(&map_k, k, bh, s_k, D) ||
       !make_map(&map_v, v, bh, s_k, D) || !make_map(&map_o, o, bh, s_q, D)))
    return cudaErrorInvalidValue;
  // units of two query blocks (fwd_next_item), one block an SM
  const long long units =
      (long long)bh * (((s_q + kFwdRows - 1) / kFwdRows + 1) / 2);
  const int sms = sm_count();
  if (sms <= 0 || units > 0x7fffffffll) return cudaErrorInvalidValue;
  return launch(flash_fwd_wgmma_kernel<D>,
                dim3((unsigned)(units < sms ? units : sms)), kFwdThreads,
                FwdSmem<D>::kAlloc, stream, map_q, map_k, map_v, map_o, lse,
                bh, s_q, s_k, scale, causal);
}

template <int D>
cudaError_t launch_forward_fp32(const void* q, const void* k, const void* v,
                                void* o, float* lse, int b, int h, int s_q,
                                int s_k, float scale, int causal,
                                cudaStream_t stream) {
  const dim3 grid((s_q + kRows - 1) / kRows, h, b);
  return launch(flash_fwd_kernel<D>, grid, kThreads, FwdSmem32<D>::kBytes,
                stream, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<float*>(o), lse, h, s_q, s_k, scale, causal);
}

template <int D>
cudaError_t launch_backward_bf16(const void* q, const void* k, const void* v,
                                 const void* o, const float* lse,
                                 const void* dout, float* stats,
                                 float* dq_acc, void* dq, void* dk, void* dv,
                                 int b, int h, int s_q, int s_k, float scale,
                                 int causal, cudaStream_t stream) {
  const int bh = b * h;
  const int n_q_tiles = (s_q + kBwdRows - 1) / kBwdRows;
  const int padded = bh * n_q_tiles * kBwdRows;
  cudaError_t err = launch(flash_bwd_prep_kernel<D>, dim3((padded + 7) / 8),
                           kThreads, 0, stream, static_cast<const bf16*>(o),
                           static_cast<const bf16*>(dout), lse, stats, dq_acc,
                           s_q, n_q_tiles, padded);
  if (err != cudaSuccess) return err;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!launch_record::current() &&
      (!make_map(&map_q, q, bh, s_q, D) || !make_map(&map_k, k, bh, s_k, D) ||
       !make_map(&map_v, v, bh, s_k, D) ||
       !make_map(&map_do, dout, bh, s_q, D)))
    return cudaErrorInvalidValue;
  err = launch(flash_bwd_wgmma_kernel<D>,
               dim3((s_k + kBwdRows - 1) / kBwdRows, h, b), kBwdThreads,
               BwdSmem<D>::kAlloc, stream, map_q, map_k, map_v, map_do,
               static_cast<const float*>(stats), dq_acc,
               static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, s_q, s_k,
               scale, causal);
  if (err != cudaSuccess) return err;
  const size_t n4 = (size_t)bh * s_q * D / 4;
  return launch(flash_bwd_dq_round_kernel,
                dim3((unsigned)((n4 + kThreads - 1) / kThreads)), kThreads, 0,
                stream, reinterpret_cast<const float4*>(dq_acc),
                static_cast<__nv_bfloat162*>(dq), n4, scale);
}

template <int D>
cudaError_t launch_backward_fp32(const void* q, const void* k, const void* v,
                                 const void* o, const float* lse,
                                 const void* dout, float* delta, void* dq,
                                 void* dk, void* dv, int b, int h, int s_q,
                                 int s_k, float scale, int causal,
                                 cudaStream_t stream) {
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  const int rows = b * h * s_q;
  cudaError_t err = launch(flash_bwd_delta_kernel<float, D>,
                           dim3((rows + 7) / 8), kThreads, 0, stream,
                           static_cast<const float*>(o), do_, delta, rows);
  if (err != cudaSuccess) return err;
  const dim3 k_grid((s_k + kRows - 1) / kRows, h, b);
  const dim3 q_grid((s_q + kRows - 1) / kRows, h, b);
  err = launch(flash_bwd_dkdv_kernel<D>, k_grid, kThreads,
               DkdvSmem<D>::kBytes, stream, q_, k_, v_, do_, lse,
               static_cast<const float*>(delta), static_cast<float*>(dk),
               static_cast<float*>(dv), h, s_q, s_k, scale, causal);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dq_kernel<D>, q_grid, kThreads, DqSmem<D>::kBytes,
                stream, q_, k_, v_, do_, lse, static_cast<const float*>(delta),
                static_cast<float*>(dq), h, s_q, s_k, scale, causal);
}

}  // namespace

// C entry points, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16;
// head_dim 64 or 128. They launch on `stream`, do not synchronise and
// allocate nothing: the caller passes o and lse, and for the backward the
// float32 scratch of its dtype — float32: delta [b, h, s_q]; bfloat16:
// dq_acc [b, h, s_q, d] and stats [b * h, ceil(s_q / 64), 2, 64] (both
// written by the prep kernel before they are read). They return
// cudaGetLastError() after the launches (0 = success).
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int b, int h, int s_q, int s_k, int d,
                                       float scale, int causal, int dtype,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_ = static_cast<float*>(lse);
  if (b <= 0 || h <= 0 || s_q <= 0 || s_k <= 0)
    return (int)cudaErrorInvalidValue;
#define FA_FWD(KIND, D) \
  return (int)launch_forward_##KIND<D>(q, k, v, o, lse_, b, h, s_q, s_k, \
                                       scale, causal, st)
  if (dtype == 0 && d == 64) FA_FWD(fp32, 64);
  if (dtype == 0 && d == 128) FA_FWD(fp32, 128);
  if (dtype == 1 && d == 64) FA_FWD(bf16, 64);
  if (dtype == 1 && d == 128) FA_FWD(bf16, 128);
#undef FA_FWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq_acc,
    void* stats, void* dq, void* dk, void* dv, int b, int h, int s_q,
    int s_k, int d, float scale, int causal, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_ = static_cast<const float*>(lse);
  if (b <= 0 || h <= 0 || s_q <= 0 || s_k <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && delta != nullptr) {
    float* delta_ = static_cast<float*>(delta);
    if (d == 64)
      return (int)launch_backward_fp32<64>(q, k, v, o, lse_, dout, delta_,
                                           dq, dk, dv, b, h, s_q, s_k, scale,
                                           causal, st);
    if (d == 128)
      return (int)launch_backward_fp32<128>(q, k, v, o, lse_, dout, delta_,
                                            dq, dk, dv, b, h, s_q, s_k,
                                            scale, causal, st);
  }
  if (dtype == 1 && dq_acc != nullptr && stats != nullptr) {
    float* acc = static_cast<float*>(dq_acc);
    float* stats_ = static_cast<float*>(stats);
    if (d == 64)
      return (int)launch_backward_bf16<64>(q, k, v, o, lse_, dout, stats_,
                                           acc, dq, dk, dv, b, h, s_q, s_k,
                                           scale, causal, st);
    if (d == 128)
      return (int)launch_backward_bf16<128>(q, k, v, o, lse_, dout, stats_,
                                            acc, dq, dk, dv, b, h, s_q, s_k,
                                            scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The launches of flash_attention_forward (backward = 0) or
// flash_attention_backward (backward = 1) for these shapes, without making
// them: out[5 i .. 5 i + 4] = grid x, y, z, threads, dynamic shared bytes
// of launch i (room for `max`). Returns the launch count, or the entry
// point's error negated.
extern "C" int flash_attention_geometry(int backward, int b, int h, int s_q,
                                        int s_k, int d, int causal,
                                        int dtype, int* out, int max) {
  void* p = launch_record::fake_ptr();
  launch_record::Scope scope(out, max);
  const int err =
      backward ? flash_attention_backward(p, p, p, p, p, p, p, p, p, p, p, p,
                                          b, h, s_q, s_k, d, 1.f, causal,
                                          dtype, nullptr)
               : flash_attention_forward(p, p, p, p, p, b, h, s_q, s_k, d,
                                         1.f, causal, dtype, nullptr);
  return launch_record::result(scope, err);
}
