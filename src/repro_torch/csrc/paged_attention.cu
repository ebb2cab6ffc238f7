// Paged decode attention over a block-table KV pool (kernel K2).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_paged_kernel
// (entry point paged_attention_fwd). Same function: one query token per row
// attends to the row's KV history, stored in scattered fixed-size pages of a
// global pool and addressed through the row's block table; pages at or past
// ceil(lengths[b] / page_size) are never read, keys at or past lengths[b]
// inside the last page are masked with -1e30, softmax and accumulation run in
// f32 with the row sum clamped at 1e-30, and the output is in q's type.
//
// What bounds it on the H100: each K/V byte read takes part in one
// multiply-add per query head of its group (g = Hq / Hkv, 4 on granite), far
// below the ~20 f32 operations per byte at which the card stops being bound
// by memory, so the bound is the bytes of the live pages. The design reads
// each live page of each kv head once, for all g query heads of the group
// (the GQA group is the row tile, as in the TPU kernel), and skips the pages
// past the length. This first version runs one block per (row, kv head) with
// no split over the sequence, so a small decode batch fills few SMs; split-K
// decoding is later work.
//
// Design: one block per (row b, kv head); 256 threads. The block reads its
// own length and walks the live pages a few at a time (about 64 tokens per
// step). At each step it first resolves the step's block-table entries once
// per token into a table of row offsets in shared memory (the TPU kernel's
// scalar prefetch), then stages K and V of those tokens in shared memory as
// f32 with 4-element vector loads: each thread keeps one 4-element column
// of the row for the whole kernel, so the staging loop does no division and
// no dependent table load per element, and its loads are independent of one
// another. It then computes the g x tokens score tile, runs the online
// softmax per query head with one warp per head, and accumulates P V into a
// g x D accumulator kept in shared memory. Tokens at or past the length are
// zero-filled and never read; table entries beyond the live pages are never
// dereferenced; a retired row whose table is all null pages reads page 0,
// which the allocator never issues. An entry outside [0, P) is read as the
// null page instead of faulting.
//
// Layouts: q (B, 1, Hq, D); pools (P, page_size, Hkv, D) with D a multiple
// of 4 and 4-element-aligned base pointers; block table (B, n_pages) int32;
// lengths (B,) int32; out (B, 1, Hq, D); all contiguous.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "smem_opt_in.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TARGET_TOKENS = 64;  // tokens staged per step
constexpr int VEC = 4;              // elements per vector load of a K/V row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive pool elements as f32 (one 16-byte load for f32, one
// 8-byte load for bf16).
__device__ __forceinline__ void load4(const float* p, float (&out)[VEC]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&out)[VEC]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = lo.x, out[1] = lo.y, out[2] = hi.x, out[3] = hi.y;
}

// Off is padded to an even count so that Vs, which takes 16-byte stores,
// starts 16-byte aligned.
__host__ __device__ int off_entries(int tk) { return (tk + 1) & ~1; }

size_t smem_bytes(int g, int D, int tk) {
  return sizeof(long long) * size_t(off_entries(tk))  // Off
         + sizeof(float) * (size_t(tk) * D         // Vs
                          + size_t(g) * D          // Qs
                          + size_t(tk) * (D + 1)   // Ks
                          + size_t(g) * tk         // Ss
                          + size_t(g) * D          // Acc
                          + 3 * size_t(g));        // Mrow, Lrow, Corr
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                  const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                  const int* __restrict__ lengths, T* __restrict__ o, int P, int ps, int Hq,
                  int Hkv, int D, int npag, int pages_per_step, float scale) {
  const int g = Hq / Hkv;
  const int tk = pages_per_step * ps;
  const int KSTR = D + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* Off = reinterpret_cast<long long*>(smem_raw);  // -1: zero-fill
  float* Vs = reinterpret_cast<float*>(Off + off_entries(tk));
  float* Qs = Vs + tk * D;
  float* Ks = Qs + g * D;
  float* Ss = Ks + tk * KSTR;
  float* Acc = Ss + g * tk;
  float* Mrow = Acc + g * D;
  float* Lrow = Mrow + g;
  float* Corr = Lrow + g;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // staging: thread tid owns vector column ch of rows r0, r0 + rows_per_pass..
  const int CH = D / VEC;
  const int rows_per_pass = THREADS / CH;
  const int ch = tid % CH, r0 = tid / CH;
  const int len = lengths[b];
  const int n_live = len > 0 ? min((len + ps - 1) / ps, npag) : 0;
  const int* btab = block_tables + size_t(b) * npag;
  const size_t q_base = (size_t(b) * Hq + size_t(hk) * g) * D;

  for (int idx = tid; idx < g * D; idx += THREADS) {
    Qs[idx] = to_f32(q[q_base + idx]) * scale;
    Acc[idx] = 0.f;
  }
  for (int i = tid; i < g; i += THREADS) {
    Mrow[i] = NEG_INF;
    Lrow[i] = 0.f;
  }

  for (int p0 = 0; p0 < n_live; p0 += pages_per_step) {
    __syncthreads();  // previous step's Off / Ss / Vs reads are done
    for (int t = tid; t < tk; t += THREADS) {  // the step's table lookups
      const int p = p0 + t / ps;
      long long off = -1;
      if (p < n_live && p0 * ps + t < len) {
        int phys = btab[p];
        if (phys < 0 || phys >= P) phys = 0;
        off = ((static_cast<long long>(phys) * ps + t % ps) * Hkv + hk) * D;
      }
      Off[t] = off;
    }
    __syncthreads();
    if (r0 < rows_per_pass) {
#pragma unroll 4
      for (int t = r0; t < tk; t += rows_per_pass) {
        const long long off = Off[t];
        float kv[VEC] = {0.f, 0.f, 0.f, 0.f}, vv[VEC] = {0.f, 0.f, 0.f, 0.f};
        if (off >= 0) {
          load4(k_pages + off + ch * VEC, kv);
          load4(v_pages + off + ch * VEC, vv);
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) Ks[t * KSTR + ch * VEC + j] = kv[j];
        *reinterpret_cast<float4*>(Vs + t * D + ch * VEC) =
            make_float4(vv[0], vv[1], vv[2], vv[3]);
      }
    }
    __syncthreads();

    for (int idx = tid; idx < g * tk; idx += THREADS) {
      const int gi = idx / tk, t = idx - gi * tk;
      float s = NEG_INF;
      if (p0 * ps + t < len) {
        const float* qr = Qs + gi * D;
        const float* kr = Ks + t * KSTR;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
        s = acc;
      }
      Ss[idx] = s;
    }
    __syncthreads();

    for (int gi = warp; gi < g; gi += WARPS) {
      float* srow = Ss + gi * tk;
      float mx = NEG_INF;
      for (int t = lane; t < tk; t += 32) mx = fmaxf(mx, srow[t]);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Mrow[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < tk; t += 32) {
        const float p = expf(srow[t] - m_new);
        srow[t] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        Corr[gi] = c;
        Lrow[gi] = Lrow[gi] * c + sum;
        Mrow[gi] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < g * D; idx += THREADS) {
      const int gi = idx / D, d = idx - gi * D;
      const float* prow = Ss + gi * tk;
      float a = Acc[idx] * Corr[gi];
      for (int t = 0; t < tk; ++t) a = fmaf(prow[t], Vs[t * D + d], a);
      Acc[idx] = a;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < g * D; idx += THREADS) {
    const int gi = idx / D;
    o[q_base + idx] = from_f32<T>(Acc[idx] / fmaxf(Lrow[gi], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* btab,
                   const int* lengths, void* o, int B, int P, int ps, int Hq, int Hkv, int D,
                   int npag, float scale, cudaStream_t stream) {
  const int pages_per_step = max(1, min(TARGET_TOKENS / ps, npag));
  const size_t smem = smem_bytes(Hq / Hkv, D, pages_per_step * ps);
  static SmemOptIn opt_in;  // one per kernel instance
  cudaError_t err = opt_in_smem(opt_in, paged_attn_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  paged_attn_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), btab,
      lengths, static_cast<T*>(o), P, ps, Hq, Hkv, D, npag, pages_per_step, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaGetLastError().
extern "C" int repro_paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                         const void* block_tables, const void* lengths, void* o,
                                         int B, int P, int ps, int Hq, int Hkv, int D, int npag,
                                         float scale, int dtype, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || ps <= 0 || npag <= 0 || D <= 0) return cudaErrorInvalidValue;
  // the staging loop's vector loads: whole 4-element columns, aligned
  const size_t esize = dtype == 1 ? 2 : 4;
  if (D % VEC != 0 || D / VEC > THREADS ||
      (reinterpret_cast<uintptr_t>(k_pages) | reinterpret_cast<uintptr_t>(v_pages)) %
              (VEC * esize) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  cudaError_t err =
      dtype == 0 ? launch<float>(q, k_pages, v_pages, bt, ln, o, B, P, ps, Hq, Hkv, D, npag,
                                 scale, s)
      : dtype == 1 ? launch<__nv_bfloat16>(q, k_pages, v_pages, bt, ln, o, B, P, ps, Hq, Hkv, D,
                                           npag, scale, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
