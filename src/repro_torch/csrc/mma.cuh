// Tensor-core and asynchronous-copy helpers for Hopper (sm_90a), inline PTX:
// warp-level mma.sync products in bf16 (m16n8k16) and in TF32 (m16n8k8,
// with the three-pass split that keeps f32 accuracy), ldmatrix for the
// transposed bf16 operand and for tf32 fragments, named barriers, 16-, 8-
// and 4-byte cp.async with zero fill, bulk
// copies by the copy engine completing on an mbarrier, and the score
// product the attention kernels share. Used by the
// flash-attention forward (flash_attention.cu: K1, B2) and backward
// (flash_attention_bwd.cu: B3, B4), and by B6 (wkv6.cu) and K2
// (paged_attention.cu) for their bulk copies and cp.async.
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
// the attention kernels read logical k t and t+4 at physical 2t and 2t+1,
// the columns a C fragment holds.

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace mma {

// f32 rounded to TF32 (10-bit mantissa), to nearest, ties away from zero;
// the low 13 bits of the result are zero. The bits of cvt.rna.tf32.f32 for
// finite x, in two integer operations: adding half of the dropped bits to
// the sign-magnitude pattern rounds the magnitude up from the halfway
// point. ptxas lowers cvt.rna to these plus a NaN test and a select, and
// the split of every loaded operand is what the f32 products spend most
// of their instructions on (B2 4.16 -> 3.57 ms, B3 5.47 -> 4.55 ms in f32
// on an H100 80GB HBM3 at 700 W, same bits; PERF.md). A NaN can come out
// as a zero hi, but then lo = x - hi is NaN, so a NaN still reaches the
// product.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
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

// Four 8x8 b16 matrices, lanes 8m to 8m + 7 giving the row addresses of
// matrix m (16-byte aligned); register m of lane 4g + t holds row g, b16
// columns 2t and 2t + 1 of matrix m. Read as 32-bit elements, a matrix is
// 8 rows x 4 columns and the lane gets element (g, t): the tf32 fragment
// layout, so one ldmatrix reads four tf32 fragment registers.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// 16, 8 or 4 bytes global -> shared, asynchronously, of which the first
// `bytes` (0 up to the copy's size) are read and the rest zero-filled: a
// row's ragged tail, or nothing for a row past the end (src then only has
// to be a valid address).
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// ------------------------------------------------- bulk copies (the copy engine)

// An mbarrier in shared memory that counts `count` arrivals.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes initialised mbarriers visible to the copy engine and the cluster;
// a block barrier must follow before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on `bar` that also expects `bytes` more bytes of bulk copies
// in the current phase.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// A barrier of `count` threads (whole warps) on named barrier `id`, 1 to
// 15 (0 is __syncthreads'): warps that share shared-memory rows meet
// without holding the rest of the block.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Orders this thread's earlier shared-memory accesses before later bulk
// copies into the same memory (the copy engine is another proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared by the copy engine, completing as transactions on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------- tiles of the attention kernels

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// A warp's 16 rows: g = lane / 4 and g + 8; its C fragment for 8-column
// tile i holds columns 8i + 2t and 8i + 2t + 1 (t = lane % 4).

template <int N>
__device__ __forceinline__ void add_into(float (&acc)[N][4], const float (&part)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
}

// A tf32 A fragment split into hi and lo.
__device__ __forceinline__ void split4(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float (&av)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const Tf32Pair s = split_tf32(av[j]);
    hi[j] = s.hi;
    lo[j] = s.lo;
  }
}

// acc (16 x 8NT) = A B^T over D in bf16: A a 16-row tile, B an 8NT-row
// tile, both row-major with stride LD (the f32 score products read their
// fragments by ldmatrix, attn_ring.cuh).
template <int D, int LD, int NT>
__device__ __forceinline__ void warp_abt(float (&acc)[NT][4], const __nv_bfloat16* A,
                                         const __nv_bfloat16* B, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 4
  for (int k = 0; k < D; k += 16) {
    const __nv_bfloat16* a = A + g * LD + k + 2 * t;
    const uint32_t af[4] = {ld_u32(a), ld_u32(a + 8 * LD), ld_u32(a + 8), ld_u32(a + 8 * LD + 8)};
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const __nv_bfloat16* b = B + (8 * i + g) * LD + k + 2 * t;
      mma_bf16(acc[i], af, ld_u32(b), ld_u32(b + 8));
    }
  }
}

}  // namespace mma
