// Causal / sliding-window GQA flash attention forward: kernel K1 and, with
// an lse output, kernel B2.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py::_attn_kernel
// (K1, the serving path's prefill) and ::_attn_kernel_lse (B2, the training
// forward, which also writes the logsumexp rows the backward kernels of
// flash_attention_bwd.cu read). Both run this one kernel: B2 passes an lse
// pointer, K1 passes null. Same function: online softmax over key tiles,
// -1e30 for masked scores, the row sum l clamped at 1e-30, every product and
// sum in f32 whatever the input type, and the output in q's type. With
// causal=0 a nonzero window is one-sided (only qpos - kpos < window), as in
// the TPU kernel and dense_attention.
//
// What bounds it on the H100: at the prefill shapes of the serving path
// (S = 128 .. 2048, D = 128) the work is ~S/2 multiply-adds per loaded byte,
// so it is bound by arithmetic. This first version does that arithmetic on
// the f32 FMA units (67 TFLOP/s), not the tensor cores, because the f32 path
// must stay f32 (TF32 would lose the 5e-4 tolerance); wgmma and a bf16
// tensor-core path are later work.
//
// Design: one block per (batch row, q head, 64-row q tile); 256 threads. The
// block loops over 64-row key tiles only up to the causal bound and from the
// window bound, so fully masked tiles are never loaded (the TPU kernel's
// pl.when skip). Q, K and V tiles are staged in shared memory as f32; each
// thread owns a 4x4 patch of the score tile and a 4-row x D/16 patch of the
// accumulator, so the softmax statistics of its four rows stay in its
// registers and the row reductions are 16-lane shuffles. Unlike the TPU
// kernel, which raises when the blocks do not tile the sequence, the kernel
// masks the ragged edge itself (keys past Sk are zero-filled and masked,
// query rows past Sq are not stored), so any prompt length is served.
//
// Layouts: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), out like q, all contiguous;
// q head h reads kv head h / (Hq / Hkv). lse (B, Hq, Sq) f32 is m + log(l)
// of the scaled scores, l clamped at 1e-30 as in the TPU kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

#include "attn_tile.cuh"
#include "smem_opt_in.cuh"

namespace {

using namespace attn;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * D + size_t(BK) * (D + 1) + size_t(BK) * D +
                          size_t(BQ) * (BK + 1));
}

template <typename T, int NC>  // head dim D = 16 * NC
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int Hq,
                int Hkv, int causal, int window, float scale) {
  constexpr int D = 16 * NC;
  constexpr int KSTR = D + 1;   // padded K row: the score loop reads down a column
  constexpr int PSTR = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x D, pre-scaled
  float* Ks = Qs + BQ * D;      // BK x KSTR
  float* Vs = Ks + BK * KSTR;   // BK x D
  float* Ps = Vs + BK * D;      // BQ x PSTR, probabilities of the current tile

  const int tid = threadIdx.x;
  // heaviest causal tiles first: they bound the tail of the launch
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int rg = tid >> 4;      // rows rg*4 .. rg*4+3
  const int cl = tid & 15;      // columns cl + 16*c

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx - r * D;
    const int qp = q0 + r;
    float val = 0.f;
    if (qp < Sq) val = to_f32(q[((size_t(b) * Sq + qp) * Hq + h) * D + c]) * scale;
    Qs[idx] = val;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's Ps / Vs reads are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx - r * D;
      const int kp = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk) {
        const size_t off = ((size_t(b) * Sk + kp) * Hkv + hk) * D + c;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      Ks[r * KSTR + c] = kv;
      Vs[r * D + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = Qs[(rg * 4 + r) * D + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = Ks[(cl + 16 * c) * KSTR + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
    }

    float corr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + rg * 4 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!visible(qp, k0 + cl + 16 * c, Sk, causal, window)) s[r][c] = NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        Ps[(rg * 4 + r) * PSTR + cl + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + sum;
      m[r] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr[r];
    for (int j = 0; j < BK; ++j) {
      float vb[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vb[c] = Vs[j * D + cl + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = Ps[(rg * 4 + r) * PSTR + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p, vb[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + rg * 4 + r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && cl == 0) lse[(size_t(b) * Hq + h) * Sq + qp] = m[r] + logf(denom);
    T* orow = o + ((size_t(b) * Sq + qp) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[cl + 16 * c] = from_f32<T>(acc[r][c] / denom);
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Sk, int Hq, int Hkv, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<16 * NC>();
  static SmemOptIn opt_in;  // one per kernel instance
  cudaError_t err = opt_in_smem(opt_in, attn_fwd_kernel<T, NC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  attn_fwd_kernel<T, NC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Sk, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Sq, int Sk, int Hq, int Hkv, int D, int causal, int window,
                       float scale, cudaStream_t stream) {
#define REPRO_FWD_CASE(NC)                                                                \
  case 16 * NC:                                                                           \
    return launch<T, NC>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, window, scale, stream);
  switch (D) {
    REPRO_FWD_CASE(1)
    REPRO_FWD_CASE(2)
    REPRO_FWD_CASE(4)
    REPRO_FWD_CASE(8)
    REPRO_FWD_CASE(10)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FWD_CASE
}

cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
                int Sk, int Hq, int Hkv, int D, int causal, int window, float scale, int dtype,
                void* stream) {
  if (Sq <= 0 || B <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? dispatch_d<float>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, D, causal, window, scale, s)
         : dtype == 1 ? dispatch_d<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, D, causal,
                                                  window, scale, s)
                      : cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaGetLastError().
// Kernel K1: the output only.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                         int causal, int window, float scale, int dtype,
                                         void* stream) {
  return static_cast<int>(
      fwd(q, k, v, o, nullptr, B, Sq, Sk, Hq, Hkv, D, causal, window, scale, dtype, stream));
}

// Kernel B2: the output and the lse rows (B, Hq, Sq) f32.
extern "C" int repro_flash_attention_fwd_lse(const void* q, const void* k, const void* v,
                                             void* o, void* lse, int B, int Sq, int Sk, int Hq,
                                             int Hkv, int D, int causal, int window, float scale,
                                             int dtype, void* stream) {
  return static_cast<int>(fwd(q, k, v, o, static_cast<float*>(lse), B, Sq, Sk, Hq, Hkv, D, causal,
                              window, scale, dtype, stream));
}
