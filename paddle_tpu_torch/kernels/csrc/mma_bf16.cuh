// bfloat16 tensor-core building blocks shared by the flash forward and the
// ragged paged-attention prefill program: cp.async staging, ldmatrix
// operands and mma.sync m16n8k16 (bf16 in, float32 accumulate) in the
// FlashAttention-2 register layout.
//
// A warp owns 16 rows of a 64-row tile and computes its 16 x 64 score tile
// as 8 m16n8 accumulators, so each thread holds two rows (g = lane / 4 and
// g + 8) and the row statistics reduce over the 4 lanes of a quad. Score
// accumulators become the A operand of the next product in registers (the C
// layout of two m16n8 tiles is the A layout of one m16k16), rounded to bf16.
// Operands come from shared tiles of 64 rows padded by 16 bytes
// (stride D + 8 elements), so 16-byte reads and ldmatrix hit distinct
// banks; ldmatrix .trans where a product contracts over the tile's rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;

// row stride, in elements, of a padded 64-row bf16 tile of head_dim D
template <int D>
constexpr int kStride = D + 8;

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
  constexpr int S = kStride<D>;
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
  constexpr int S = kStride<D>;
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
// of each m16n8 tile, written as bf16 pairs with `mul` applied
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

}  // namespace mma_bf16
