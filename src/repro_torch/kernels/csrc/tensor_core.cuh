// Tensor-core building blocks shared by the bfloat16 kernels
// (flash_attention.cu, crossentropy.cu, ssd.cu) for Hopper (sm_90a).
//
// Both kernels run the same machinery: bfloat16 operand tiles staged in
// shared memory by asynchronous 16-byte copies (cp.async) into a ring of
// stages, fragments read with ldmatrix, products on the tensor cores with
// mma.sync.m16n8k16 (bf16 x bf16, accumulated in float32 registers), and a
// row-wise online max / sum over the accumulator fragment.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major)  a0 = A[g][2t..2t+1]     a1 = A[g+8][2t..2t+1]
//                           a2 = A[g][2t+8..2t+9]   a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, "col")       b0 = B[2t..2t+1][g]     b1 = B[2t+8..2t+9][g]
//   C (16 x 8, float32)     c0, c1 = C[g][2t..2t+1] c2, c3 = C[g+8][2t..2t+1]
// so a thread holds two rows of a 16-row tile (g and g + 8), and the four
// lanes of a quad (the same g) hold all the columns of those rows: a row's
// max and sum over a tile are a thread-local pass plus two shuffles.
//
// Shared tiles are row-major with a row stride of the tile's width plus 8
// elements (16 bytes): the eight 16-byte rows an ldmatrix reads then start
// in eight distinct 4-bank groups for every width used (16 ... 256), so the
// reads are free of bank conflicts without a swizzle, and every row start
// stays 16-byte aligned for cp.async.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace tc {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared.  Only the first `bytes` (0 ...
// 16) are read from `src`; the rest of the 16 shared bytes are zero-filled.
// `src` is 16-byte aligned and a valid address even when `bytes` is 0.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages the [ROWS, COLS] tile at `src` (element (r, c) at src[r * ld + c])
// into shared memory at `dst` (row stride LDS) with cp.async: rows at or past
// `rows` and columns at or past `cols` are zero-filled, so ragged edges need
// no padded copy in device memory.  COLS is a multiple of 8; `ld` a multiple
// of 8 and `src` 16-byte aligned (every 16-byte chunk starts aligned).
template <int ROWS, int COLS, int LDS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld, int rows,
                                          int cols) {
  constexpr int kChunksPerRow = COLS / 8;
  constexpr int kChunks = ROWS * kChunksPerRow;
  static_assert(COLS % 8 == 0, "tile width in 16-byte chunks");
#pragma unroll
  for (int i = 0; i < (kChunks + THREADS - 1) / THREADS; ++i) {
    const int c = static_cast<int>(threadIdx.x) + i * THREADS;
    if (kChunks % THREADS == 0 || c < kChunks) {
      const int r = c / kChunksPerRow;
      const int col = (c % kChunksPerRow) * 8;
      int bytes = 0;
      if (r < rows && col < cols) bytes = 2 * min(8, cols - col);
      const bf16* from = bytes ? src + r * ld + col : src;
      cp_async_16(dst + r * LDS + col, from, bytes);
    }
  }
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8i .. 8i + 7 give the
// row addresses of matrix i, and r[i] holds this lane's pair of matrix i
// (row lane / 4, columns 2 (lane % 4) .. +1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed: r[i] holds (rows 2 (lane % 4) .. +1,
// column lane / 4) of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += A B on the tensor cores: A 16 x 16 bf16, B 16 x 8 bf16, d float32.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8 x 8 bf16 matrices, each transposed: lanes 0 .. 7 give the row
// addresses of matrix 0 and lanes 8 .. 15 those of matrix 1 (the other lanes'
// addresses are not read); r[i] holds (rows 2 (lane % 4) .. +1, column
// lane / 4) of matrix i.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// Lane offsets (in elements, for a tile of row stride LDS) of the ldmatrix
// addresses that give:
//  - an A fragment of the 16 x 16 block at the tile's origin (rows of A are
//    tile rows); also the B fragments, with ldmatrix_x4_trans, of two 8-wide
//    column blocks when B's rows (the depth) are tile rows (r[0], r[1]: block
//    0's b0, b1; r[2], r[3]: block 1's);
template <int LDS>
__device__ __forceinline__ int a_offset(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8;
}
//  - with ldmatrix_x4, the B fragments of two 8-wide column blocks when B's
//    columns are tile rows and its depth runs along them (K-major: keys in
//    Q K^T, the vocabulary of a [V, D] head), in the same order.
template <int LDS>
__device__ __forceinline__ int b_offset(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * LDS + ((lane >> 3) & 1) * 8;
}

// Two floats as one register of two bf16 (round to nearest even), `lo` in
// the low half: the element of the smaller column index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats as two registers of bf16 pairs, hi = round(x) and lo =
// round(x - hi), so hi + lo carries x to about 2^-17 of its size: a product
// with a bf16 operand taken as hi B + lo B keeps float32-grade x where one
// rounding of x would move it by up to 2^-9.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// Two floats as three registers of bf16 pairs, hi = round(x), mid =
// round(x - hi), lo = round(x - hi - mid): hi + mid + lo carries x to about
// 2^-24 of its size, float32's own grade (two terms keep about 2^-16).
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  split_bf16(x0 - hf.x, x1 - hf.y, mid, lo);
}

// 2^x on the special-function unit (ex2.approx: 2 ulp, denormal results
// flushed to 0), without exp2f's rescaling around denormals: the online
// softmax's terms below 2^-126 of the row max do not count.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the four lanes of a quad (the lanes that share a row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Online logsumexp state in base 2: the row's running max m of the scores
// times log2(e), and l = sum_j 2^(x_j - m).  Folds another state (m_o, l_o)
// into (m, l).  A state that has seen only masked scores (m = kMasked) is
// wiped by the first real one: 2^(kMasked - m_real) = 0.
__device__ __forceinline__ void lse2_merge(float& m, float& l, float m_o, float l_o) {
  const float mn = fmaxf(m, m_o);
  l = l * exp2f(m - mn) + l_o * exp2f(m_o - mn);
  m = mn;
}

}  // namespace tc
