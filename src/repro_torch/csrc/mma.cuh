// Tensor-core and asynchronous-copy helpers for Hopper (sm_90a), inline PTX:
// warp-level mma.sync products in bf16 (m16n8k16) and in TF32 (m16n8k8,
// with the three-pass split that keeps f32 accuracy), ldmatrix for the
// transposed bf16 operand, and 16- and 4-byte cp.async with zero fill.
// Used by the flash-attention backward (flash_attention_bwd.cu: B3, B4).
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k*"), with
// g = lane / 4 and t = lane % 4:
//   m16n8k8 tf32   A a0 (g, t)    a1 (g+8, t)    a2 (g, t+4)    a3 (g+8, t+4)
//                  B b0 (k t, n g)      b1 (k t+4, n g)
//   m16n8k16 bf16  A a0 (g, 2t..2t+1)   a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//                  B b0 (k 2t..2t+1, n g)   b1 (k 2t+8..2t+9, n g)
//   both           C c0 (g, 2t)   c1 (g, 2t+1)   c2 (g+8, 2t)   c3 (g+8, 2t+1)
// A sum over k does not depend on the order of k, so a product may read
// its k positions in any order that A and B share: the tf32 products of
// the backward read logical k t and t+4 at physical 2t and 2t+1, the
// columns a C fragment holds.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

// f32 rounded to TF32 (10-bit mantissa), to nearest, ties away from zero;
// the low 13 bits of the result are zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|): hi = tf32(x), lo = tf32(x - hi).
struct Tf32Pair {
  uint32_t hi, lo;
};
__device__ __forceinline__ Tf32Pair split_tf32(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

// c += a b, m16n8k8, TF32 inputs, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[i] += a b[i] over N 8-column tiles in f32 accuracy from three TF32
// products per tile, with b[i] split into (b0[i], b1[i]): the small terms
// lo*hi and hi*lo into `small`, hi*hi into `big` (lo*lo, 2^-22 relative,
// is dropped). Each pass runs over all N tiles, so consecutive mma do not
// wait on each other. With big and small the same array, the small terms
// enter first; with two arrays, the caller adds small to big at the end.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&big)[N][4], float (&small)[N][4],
                                           const uint32_t ahi[4], const uint32_t alo[4],
                                           const Tf32Pair (&b0)[N], const Tf32Pair (&b1)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(small[i], alo, b0[i].hi, b1[i].hi);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(small[i], ahi, b0[i].lo, b1[i].lo);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(big[i], ahi, b0[i].hi, b1[i].hi);
}

// c += a b, m16n8k16, bf16 pairs packed in 32 bits, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two 8x8 b16 matrices, transposed: lanes 0-7 give the row addresses of
// the first, lanes 8-15 of the second (lanes 16-31 must hold valid
// addresses too). For a row-major [k][n] tile with row p of the first at
// k0 + p and of the second at k0 + 8 + p, both at column n0, r0 and r1 are
// the m16n8k16 B fragment of that k16 x n8 block.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(row))
               : "memory");
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes global -> shared, asynchronously; zeros where !valid (src-size
// 0: nothing is read, src only has to be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mma
