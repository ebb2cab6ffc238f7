// Hopper's warpgroup products and tensor copies (sm_90a), inline PTX, in
// the style of mma.cuh: wgmma.mma_async on bf16 inputs with f32
// accumulators (A and B from shared memory, or A from registers), the
// shared-memory matrix descriptors of 128-byte-swizzled tiles, TMA loads
// (cp.async.bulk.tensor) from a CUtensorMap completing on an mbarrier,
// setmaxnreg, and the host's encoding of a tensor map, looked up at run
// time (cudaGetDriverEntryPoint), so the library links without -lcuda,
// and the host's rule for the consumer warpgroups of a block (groups).
// Used by the bf16 flash-attention kernels at D 64 and 128: the forward
// (flash_attention.cu: K1, B2) and the backward (flash_attention_bwd.cu:
// B3, B4); the backward's mma.sync kernels take its tensor maps (map_box),
// TMA loads, mbarriers and SM count too.
//
// Tiles in shared memory are what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
// writes for a box 64 bf16 wide: rows of 128 bytes, the 16-byte chunks of
// row r at chunk c ^ (r % 8), eight rows (1024 bytes) a swizzle atom, the
// tile's base on a 1024-byte boundary. A wider row (D = 128) is two such
// tiles, one per 64 columns, one after the other.
//
// Fragments (PTX ISA, "Register Fragments and Shared Memory Matrix Layouts"
// of wgmma.m64nNk16): warp w of the warpgroup owns rows 16w + g and
// 16w + g + 8 (g = lane / 4, t = lane % 4). Its f32 accumulator holds, for
// each 8-column tile i of N, d[4i] = (g, 8i + 2t), d[4i + 1] = (g, 8i + 2t +
// 1), d[4i + 2] and d[4i + 3] the same columns of row g + 8: mma.sync's C
// fragment, repeated. An A operand in registers is mma.sync's m16n8k16 A
// fragment of the warp's rows: a score tile's accumulator for keys 16j ..
// 16j + 15 (tiles 2j and 2j + 1), packed to bf16 pairs, is the A operand of
// the product with those keys' values, with no trip through shared memory.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "mma.cuh"

namespace wg {

// The descriptor of a 128-byte-swizzled tile (above) for wgmma: start
// address, leading and stride byte offsets, each in 16-byte units, and the
// layout (1 = 128-byte swizzle) in bits 62-63. K-major operands (Q and K of
// Q K^T, k along the 128-byte row): the stride offset steps over 8-row
// groups (1024 bytes), the leading offset is unused, and the k16 step s
// starts 32 s bytes into the row (the swizzle is a function of the address,
// so an offset start inside the atom reads the right chunks). MN-major
// operands (V of P V, n along the row, k down the rows): the stride offset
// steps over 8 k rows (1024 bytes), the leading offset over 64-column
// tiles (an n64 product reads one tile), and the k16 step s starts 16 rows
// (2048 bytes) further. Every descriptor here has the same high word
// (stride 1024 bytes, 128-byte swizzle): a product takes the low word
// (start address and leading offset, desc_lo) in a register, adds its
// step's offset (an immediate, in 16-byte units) and ORs in the high word
// itself, so a loop of products keeps one 32-bit register per operand
// live, not a 64-bit descriptor per step.
constexpr unsigned long long kDescHigh = (1ull << 62) | (uint64_t(1024 >> 4) << 32);

__device__ __forceinline__ uint32_t desc_lo(uint32_t tile, uint32_t lead_bytes) {
  return ((tile & 0x3ffff) >> 4) | (((lead_bytes >> 4) & 0x3fff) << 16);
}

// f(std::integral_constant<int, I>) for I = B .. E - 1, unrolled: the step
// index of a run of products is a constant, so its offsets are immediates.
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

// Orders earlier register and shared-memory writes before the next
// wgmma.mma_async; needed before the first product of a batch whose
// accumulators or A registers other instructions wrote.
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Closes the batch of products started since the last commit.
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed batches are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// this point (the product writes it asynchronously, after it starts).
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The register budget of each thread of the calling warpgroup (all its
// warps run it): give registers back to the block's pool, or take them.
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The mbarrier and copy helpers below take shared-memory addresses
// (mma::smem_addr), 32 bits, so a loop over stages keeps no 64-bit
// pointers live.

// One arrival on the mbarrier at `bar`.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Expects `bytes` more bytes of copies this phase, without arriving.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One arrival that also expects `bytes` more bytes of copies this phase.
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of the mbarrier at `bar` with the given parity has
// completed. A phase that has not completed after about 2^34 cycles (8.7 s
// at 1.98 GHz) never will (a copy that cannot land): the kernel traps, so
// the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_test(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_test(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// The box at coordinates (c0, c1, c2, c3) of a 4-D tensor map (innermost
// first) -> shared memory at dst, completing as transactions on the
// mbarrier at `bar` (the box's full size: elements outside the tensor are
// zero-filled).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// d (64 x N, this thread's share) = ACC ? d + A B : A B over one k16 step,
// bf16 inputs, f32 accumulators: mma_ss (N 64 or 128) with A and B from
// shared memory (both K-major; descriptor low words a, b plus OFF_A,
// OFF_B), mma_rs (N 64) with A from registers and B from shared memory
// MN-major (the transpose bit).
template <int OFF_A, int OFF_B, int ACC>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint32_t a, uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 la, lb;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "add.u32 la, %32, %35;\n"
      "add.u32 lb, %33, %36;\n"
      "cvt.u64.u32 da, la;\n"
      "cvt.u64.u32 db, lb;\n"
      "or.b64 da, da, %37;\n"
      "or.b64 db, db, %37;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a), "r"(b), "r"(ACC), "n"(OFF_A), "n"(OFF_B), "n"(kDescHigh));
}

template <int OFF_B, int ACC>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 lb;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "add.u32 lb, %36, %38;\n"
      "cvt.u64.u32 db, lb;\n"
      "or.b64 db, db, %39;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(ACC), "n"(OFF_B),
        "n"(kDescHigh));
}

template <int OFF_A, int OFF_B, int ACC>
__device__ __forceinline__ void mma_ss(float (&d)[64], uint32_t a, uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 la, lb;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "add.u32 la, %64, %67;\n"
      "add.u32 lb, %65, %68;\n"
      "cvt.u64.u32 da, la;\n"
      "cvt.u64.u32 db, lb;\n"
      "or.b64 da, da, %69;\n"
      "or.b64 db, db, %69;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a), "r"(b), "r"(ACC), "n"(OFF_A), "n"(OFF_B), "n"(kDescHigh));
}

// ----------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once in the CUDA library the runtime
// has loaded.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a contiguous (B, S, H, D) tensor (f32 or bf16) as the
// 4-D (D, H, S, B), innermost first, in boxes of `cols` columns x 1 head x
// `rows` rows x 1 batch row. A box past S (or a batch row's end) reads
// zeros, never the next batch row; so do columns past D, which is how a
// box of D + pad columns writes the padded rows of the mma.sync backward
// (flash_attention_bwd.cu). base must be 16-byte aligned (TMA's rule; the
// entry points refuse others).
inline cudaError_t map_box(CUtensorMap* map, const void* base, bool f32, int B, int S, int H,
                           int D, int cols, int rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {D * es, cuuint64_t(H) * D * es, cuuint64_t(S) * H * D * es};
  const cuuint32_t box[4] = {cuuint32_t(cols), 1, cuuint32_t(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      const_cast<void*>(base), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 tensor in boxes of 64 columns, 128-byte swizzled (the wgmma
// kernels' tiles).
inline cudaError_t map_rows(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                            int rows) {
  return map_box(map, base, false, B, S, H, D, 64, rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The SM count of the current device, asked of the runtime once per
// device: every launch of a wgmma kernel reads it (groups).
inline int sm_count() {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];  // 0: not asked yet
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  const bool cached = dev >= 0 && dev < kDevices;
  if (cached) sms = known[dev].load(std::memory_order_relaxed);
  if (sms > 0) return sms;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms <= 0)
    return 132;
  if (cached) known[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

// Consumer warpgroups a block of a wgmma kernel that tiles `rows` rows of
// each of `heads` (batch rows x heads): 2 (128 rows a block) when the grid
// of 128-row tiles fills the SMs, else 1 (64 rows, twice the blocks). The
// forward (K1/B2: q rows of each q head), B3 (the same) and B4 (key rows of
// each kv head) share it.
inline int groups(long heads, int rows) {
  return heads * ((rows + 127) / 128) >= sm_count() ? 2 : 1;
}

}  // namespace wg
