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
// Two sets of kernels, one design:
// - bfloat16 runs on the tensor cores: mma.sync m16n8k16 with float32
//   accumulation, ldmatrix operands, the FlashAttention-2 register layout
//   (4 warps of 16 rows, probabilities kept in registers as the next
//   product's operand, rounded to bf16 as the plain version rounds them);
// - float32 runs on the CUDA cores in float32 (a 16 x 16 thread grid, a
//   4 x 4 micro-tile per thread): the tensor cores have no full-float32
//   product, and float32 is the precision the checks compare against.
// wgmma, TMA and warp specialisation are later work.
//
// What the design does about it:
// - the S x S score matrix never reaches device memory: a block owns 64
//   query rows (forward, dq) or 64 key rows (dk/dv) of one (batch, head)
//   and walks the other side in 64-row tiles with an online softmax
//   (running max, running sum, float32 accumulators in registers);
// - tiles are staged in shared memory with cp.async (16 bytes per copy,
//   zero-filled past the sequence end) into a two-stage ring, so the next
//   tile's loads are in flight while the current one is computed; rows
//   are padded by 16 bytes so 16-byte reads and ldmatrix hit distinct
//   banks;
// - causal: a tile wholly above the diagonal is skipped, not loaded; the
//   heaviest query blocks are scheduled first;
// - the backward is three kernels: delta = rowsum(do * o); one block per
//   key tile accumulating dk and dv over the query tiles that see it; one
//   block per query tile accumulating dq (no atomics: deterministic).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// 16-byte asynchronous copy; src_bytes = 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);  // all but the newest group
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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
struct FwdSmem {
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


// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: mma.sync m16n8k16 (bf16 in, float32
// accumulate), the FlashAttention-2 layout. A block is 4 warps; a warp owns
// 16 rows of its block's 64 (queries, or keys in dk/dv) and computes its
// 16 x 64 score tile as 8 m16n8 accumulators, so each thread holds two
// rows (g = lane / 4 and g + 8) and the row statistics reduce over the 4
// lanes of a quad. Score accumulators become the A operand of the next
// product in registers (the C layout of two m16n8 tiles is the A layout of
// one m16k16), rounded to bf16 as the plain version rounds the
// probabilities. Operands come from the padded shared tiles with ldmatrix
// (.trans where the product contracts over the tile's rows).

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a b for one m16n8k16 tile
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

// the A operand (16 x 16, row-major) at (row0, col0) of a padded tile
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int stride,
                                              int row0, int col0, int lane) {
  return tile + (row0 + (lane & 15)) * stride + col0 + ((lane >> 4) << 3);
}

// B operands of two n8 tiles (n0, n0 + 8) over k16 at k0, from a tile laid
// out [n][k] (the rows are the product's columns)
__device__ __forceinline__ const bf16* bn_addr(const bf16* tile, int stride,
                                               int n0, int k0, int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * stride + k0 +
         (((lane >> 3) & 1) << 3);
}

// the same from a tile laid out [k][n] (loaded with .trans)
__device__ __forceinline__ const bf16* bt_addr(const bf16* tile, int stride,
                                               int k0, int n0, int lane) {
  return tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * stride + n0 +
         ((lane >> 4) << 3);
}

// acc (16 x 64, 8 m16n8 tiles) += A rows [row0, row0 + 16) of `a` times the
// 64 rows of `b`, both [rows][D] padded tiles: A B^T over D
template <int D>
__device__ __forceinline__ void mma_abt(const bf16* a, int row0, const bf16* b,
                                        int lane, float (&acc)[8][4]) {
  constexpr int S = Tile<bf16, D>::kStride;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned af[4];
    ldsm_x4(af, a_addr(a, S, row0, kk * 16, lane));
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      unsigned bf[4];
      ldsm_x4(bf, bn_addr(b, S, jp * 16, kk * 16, lane));
      mma16816(acc[2 * jp], af, bf[0], bf[1]);
      mma16816(acc[2 * jp + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D) += P (16 x 64, score accumulators, rounded to bf16) times
// the 64 x D tile `x` (rows are the contraction)
template <int D>
__device__ __forceinline__ void mma_px(const float (&p)[8][4], const bf16* x,
                                       int lane, float (&acc)[D / 8][4]) {
  constexpr int S = Tile<bf16, D>::kStride;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const unsigned pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      unsigned bf[4];
      ldsm_x4_t(bf, bt_addr(x, S, kk * 16, dp * 16, lane));
      mma16816(acc[2 * dp], pa, bf[0], bf[1]);
      mma16816(acc[2 * dp + 1], pa, bf[2], bf[3]);
    }
  }
}

// reductions over the 4 lanes of a quad (one row of a warp's tile)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [row0, row0 + 16) of a [rows][D] accumulator set, rows g and g + 8
// of each m16n8 tile, written as bf16 pairs with `scale` applied
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, size_t row_base,
                                           int row, int n_rows,
                                           const float (&acc)[D / 8][4],
                                           int hh, float mul, int t) {
  if (row >= n_rows) return;
  bf16* dst = out + (row_base + row) * D + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(
        acc[n][2 * hh] * mul, acc[n][2 * hh + 1] * mul);
}

template <int D>
struct MmaSmem {
  static constexpr size_t kTile = Tile<bf16, D>::kElems * sizeof(bf16);
  static constexpr size_t kFwd = 5 * kTile;  // q, two stages of (k, v)
  static constexpr size_t kDkdv = 4 * kTile + 2 * kRows * sizeof(float);
  static constexpr size_t kDq = 6 * kTile + 2 * kRows * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int h, int s_q, int s_k,
                     float scale, int causal) {
  using L = Tile<bf16, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + L::kElems;  // [stage][k, v][kRows][kStride]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest first
  const size_t bh = (size_t)blockIdx.z * h + blockIdx.y;
  const int off = s_k - s_q;
  const bf16* kg = k + bh * s_k * D;
  const bf16* vg = v + bh * s_k * D;

  const int q_last = min(q0 + kRows, s_q) - 1;
  const int n_kv = keys_needed(q0, q_last, s_k, off, causal);
  const int n_tiles = (n_kv + kRows - 1) / kRows;

  load_tile<bf16, D, kMmaThreads>(q_s, q + bh * s_q * D, q0, s_q);
  load_tile<bf16, D, kMmaThreads>(kv_s, kg, 0, s_k);
  load_tile<bf16, D, kMmaThreads>(kv_s + L::kElems, vg, 0, s_k);
  cp_async_commit();

  float acc[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      bf16* next = kv_s + ((tile + 1) & 1) * 2 * L::kElems;
      load_tile<bf16, D, kMmaThreads>(next, kg, (tile + 1) * kRows, s_k);
      load_tile<bf16, D, kMmaThreads>(next + L::kElems, vg,
                                      (tile + 1) * kRows, s_k);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const bf16* k_s = kv_s + (tile & 1) * 2 * L::kElems;
    const bf16* v_s = k_s + L::kElems;
    const int j0 = tile * kRows;

    float s[8][4] = {};
    mma_abt<D>(q_s, warp * 16, k_s, lane, s);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int lim = q0 + warp * 16 + g + 8 * hh + off;  // last key seen
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j0 + 8 * j + 2 * t + e;
          float x = s[j][2 * hh + e] * scale;
          if (col >= s_k)
            x = -INFINITY;  // no such key
          else if (causal && col > lim)
            x = kMaskFill;
          s[j][2 * hh + e] = x;
          mx = fmaxf(mx, x);
        }
      // finite: key j0 < s_k is in this tile and scores at least -1e30
      const float m_new = fmaxf(m[hh], quad_max(mx));
      const float alpha = expf(m[hh] - m_new);  // 0 on the first tile
      m[hh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[j][2 * hh + e] - m_new);
          s[j][2 * hh + e] = p;
          sum += p;
        }
      l[hh] = l[hh] * alpha + sum;  // this thread's part of the row sum
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * hh] *= alpha;
        acc[n][2 * hh + 1] *= alpha;
      }
    }
    mma_px<D>(s, v_s, lane, acc);
    __syncthreads();  // stage tile & 1 is free
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float l_row = quad_sum(l[hh]);
    const int row = q0 + warp * 16 + g + 8 * hh;
    store_rows<D>(o, bh * s_q, row, s_q, acc, hh, 1.f / l_row, t);
    if (t == 0 && row < s_q) lse[bh * s_q + row] = m[hh] + logf(l_row);
  }
}

// one block per 64-key tile, a warp per 16 keys: dv = P^T do and
// dk = scale * dS^T q over the query tiles that see the keys
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int h,
                          int s_q, int s_k, float scale, int causal) {
  using L = Tile<bf16, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + L::kElems;
  bf16* q_s = v_s + L::kElems;
  bf16* do_s = q_s + L::kElems;
  float* lse_s = reinterpret_cast<float*>(do_s + L::kElems);
  float* delta_s = lse_s + kRows;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kRows;
  const size_t bh = (size_t)blockIdx.z * h + blockIdx.y;
  const int off = s_k - s_q;
  const bf16* qg = q + bh * s_q * D;
  const bf16* dog = dout + bh * s_q * D;

  load_tile<bf16, D, kMmaThreads>(k_s, k + bh * s_k * D, k0, s_k);
  load_tile<bf16, D, kMmaThreads>(v_s, v + bh * s_k * D, k0, s_k);
  cp_async_commit();

  const int t_begin = (causal && off >= 0) ? max(0, k0 - off) / kRows : 0;
  const int n_q_tiles = (s_q + kRows - 1) / kRows;

  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};

  for (int tile = t_begin; tile < n_q_tiles; ++tile) {
    const int q0 = tile * kRows;
    load_tile<bf16, D, kMmaThreads>(q_s, qg, q0, s_q);
    load_tile<bf16, D, kMmaThreads>(do_s, dog, q0, s_q);
    cp_async_commit();
    if (threadIdx.x < kRows) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < s_q ? lse[bh * s_q + row] : 0.f;
      delta_s[threadIdx.x] = row < s_q ? delta[bh * s_q + row] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    float st[8][4] = {}, dpt[8][4] = {};
    mma_abt<D>(k_s, warp * 16, q_s, lane, st);   // S^T: keys x queries
    mma_abt<D>(v_s, warp * 16, do_s, lane, dpt); // dP^T
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k0 + warp * 16 + g + 8 * hh;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * j + 2 * t + e;
          float p, ds;
          prob_and_ds(st[j][2 * hh + e], dpt[j][2 * hh + e], q0 + r, key,
                      s_q, s_k, off, causal, scale, lse_s[r], delta_s[r], p,
                      ds);
          st[j][2 * hh + e] = p;
          dpt[j][2 * hh + e] = ds;
        }
    }
    mma_px<D>(st, do_s, lane, dv_acc);
    mma_px<D>(dpt, q_s, lane, dk_acc);
    __syncthreads();  // q_s, do_s, lse_s and delta_s are free
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + warp * 16 + g + 8 * hh;
    store_rows<D>(dk, bh * s_k, key, s_k, dk_acc, hh, scale, t);
    store_rows<D>(dv, bh * s_k, key, s_k, dv_acc, hh, 1.f, t);
  }
}

// one block per 64-query tile, a warp per 16 queries: dq = scale * dS k
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int h, int s_q, int s_k,
                        float scale, int causal) {
  using L = Tile<bf16, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + L::kElems;
  bf16* kv_s = do_s + L::kElems;  // [stage][k, v][kRows][kStride]
  float* lse_s = reinterpret_cast<float*>(kv_s + 4 * L::kElems);
  float* delta_s = lse_s + kRows;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest first
  const size_t bh = (size_t)blockIdx.z * h + blockIdx.y;
  const int off = s_k - s_q;
  const bf16* kg = k + bh * s_k * D;
  const bf16* vg = v + bh * s_k * D;

  // rows that see no key carry no score gradient
  const int q_last = min(q0 + kRows, s_q) - 1;
  const int n_kv = causal ? max(0, min(s_k, q_last + off + 1)) : s_k;
  const int n_tiles = (n_kv + kRows - 1) / kRows;

  load_tile<bf16, D, kMmaThreads>(q_s, q + bh * s_q * D, q0, s_q);
  load_tile<bf16, D, kMmaThreads>(do_s, dout + bh * s_q * D, q0, s_q);
  if (n_tiles > 0) {
    load_tile<bf16, D, kMmaThreads>(kv_s, kg, 0, s_k);
    load_tile<bf16, D, kMmaThreads>(kv_s + L::kElems, vg, 0, s_k);
  }
  cp_async_commit();
  if (threadIdx.x < kRows) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < s_q ? lse[bh * s_q + row] : 0.f;
    delta_s[threadIdx.x] = row < s_q ? delta[bh * s_q + row] : 0.f;
  }

  float acc[D / 8][4] = {};

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      bf16* next = kv_s + ((tile + 1) & 1) * 2 * L::kElems;
      load_tile<bf16, D, kMmaThreads>(next, kg, (tile + 1) * kRows, s_k);
      load_tile<bf16, D, kMmaThreads>(next + L::kElems, vg,
                                      (tile + 1) * kRows, s_k);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const bf16* k_s = kv_s + (tile & 1) * 2 * L::kElems;
    const bf16* v_s = k_s + L::kElems;
    const int j0 = tile * kRows;

    float s[8][4] = {}, dp[8][4] = {};
    mma_abt<D>(q_s, warp * 16, k_s, lane, s);
    mma_abt<D>(do_s, warp * 16, v_s, lane, dp);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + g + 8 * hh;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p, ds;
          prob_and_ds(s[j][2 * hh + e], dp[j][2 * hh + e], q0 + r,
                      j0 + 8 * j + 2 * t + e, s_q, s_k, off, causal, scale,
                      lse_s[r], delta_s[r], p, ds);
          s[j][2 * hh + e] = ds;
        }
    }
    mma_px<D>(s, k_s, lane, acc);
    __syncthreads();
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    store_rows<D>(dq, bh * s_q, q0 + warp * 16 + g + 8 * hh, s_q, acc, hh,
                  scale, t);
}

template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, int threads,
                   size_t smem, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T>
constexpr bool kTensorCores = std::is_same<T, bf16>::value;

template <typename T, int D>
cudaError_t launch_forward(const void* q, const void* k, const void* v,
                           void* o, float* lse, int b, int h, int s_q,
                           int s_k, float scale, int causal,
                           cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  T* o_ = static_cast<T*>(o);
  const dim3 grid((s_q + kRows - 1) / kRows, h, b);
  if constexpr (kTensorCores<T>)
    return launch(flash_fwd_mma_kernel<D>, grid, kMmaThreads,
                  MmaSmem<D>::kFwd, stream, q_, k_, v_, o_, lse, h, s_q, s_k,
                  scale, causal);
  else
    return launch(flash_fwd_kernel<D>, grid, kThreads,
                  FwdSmem<D>::kBytes, stream, q_, k_, v_, o_, lse, h, s_q,
                  s_k, scale, causal);
}

template <typename T, int D>
cudaError_t launch_backward(const void* q, const void* k, const void* v,
                            const void* o, const float* lse, const void* dout,
                            float* delta, void* dq, void* dk, void* dv, int b,
                            int h, int s_q, int s_k, float scale, int causal,
                            cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  T* dq_ = static_cast<T*>(dq);
  T* dk_ = static_cast<T*>(dk);
  T* dv_ = static_cast<T*>(dv);
  const int rows = b * h * s_q;
  cudaError_t err = launch(flash_bwd_delta_kernel<T, D>, dim3((rows + 7) / 8),
                           kThreads, 0, stream, static_cast<const T*>(o), do_,
                           delta, rows);
  if (err != cudaSuccess) return err;
  const dim3 k_grid((s_k + kRows - 1) / kRows, h, b);
  const dim3 q_grid((s_q + kRows - 1) / kRows, h, b);
  if constexpr (kTensorCores<T>) {
    err = launch(flash_bwd_dkdv_mma_kernel<D>, k_grid, kMmaThreads,
                 MmaSmem<D>::kDkdv, stream, q_, k_, v_, do_, lse,
                 static_cast<const float*>(delta), dk_, dv_, h, s_q, s_k,
                 scale, causal);
    if (err != cudaSuccess) return err;
    return launch(flash_bwd_dq_mma_kernel<D>, q_grid, kMmaThreads,
                  MmaSmem<D>::kDq, stream, q_, k_, v_, do_, lse,
                  static_cast<const float*>(delta), dq_, h, s_q, s_k, scale,
                  causal);
  } else {
    err = launch(flash_bwd_dkdv_kernel<D>, k_grid, kThreads,
                 DkdvSmem<D>::kBytes, stream, q_, k_, v_, do_, lse,
                 static_cast<const float*>(delta), dk_, dv_, h, s_q, s_k,
                 scale, causal);
    if (err != cudaSuccess) return err;
    return launch(flash_bwd_dq_kernel<D>, q_grid, kThreads,
                  DqSmem<D>::kBytes, stream, q_, k_, v_, do_, lse,
                  static_cast<const float*>(delta), dq_, h, s_q, s_k, scale,
                  causal);
  }
}

}  // namespace

// C entry points, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16;
// head_dim 64 or 128. They launch on `stream`, do not synchronise,
// allocate nothing (the caller passes o, lse, delta, dq, dk, dv), and
// return cudaGetLastError() after the launches (0 = success).
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int b, int h, int s_q, int s_k, int d,
                                       float scale, int causal, int dtype,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_ = static_cast<float*>(lse);
  if (b <= 0 || h <= 0 || s_q <= 0 || s_k <= 0)
    return (int)cudaErrorInvalidValue;
#define FA_FWD(T, D) \
  return (int)launch_forward<T, D>(q, k, v, o, lse_, b, h, s_q, s_k, scale, causal, st)
  if (dtype == 0 && d == 64) FA_FWD(float, 64);
  if (dtype == 0 && d == 128) FA_FWD(float, 128);
  if (dtype == 1 && d == 64) FA_FWD(__nv_bfloat16, 64);
  if (dtype == 1 && d == 128) FA_FWD(__nv_bfloat16, 128);
#undef FA_FWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int b, int h, int s_q, int s_k, int d, float scale, int causal,
    int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  if (b <= 0 || h <= 0 || s_q <= 0 || s_k <= 0)
    return (int)cudaErrorInvalidValue;
#define FA_BWD(T, D)                                                        \
  return (int)launch_backward<T, D>(q, k, v, o, lse_, dout, delta_, dq, dk, dv, b, \
                             h, s_q, s_k, scale, causal, st)
  if (dtype == 0 && d == 64) FA_BWD(float, 64);
  if (dtype == 0 && d == 128) FA_BWD(float, 128);
  if (dtype == 1 && d == 64) FA_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && d == 128) FA_BWD(__nv_bfloat16, 128);
#undef FA_BWD
  return (int)cudaErrorInvalidValue;
}
