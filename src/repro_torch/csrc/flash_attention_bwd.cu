// Causal / sliding-window GQA flash-attention backward: kernels B3 (dq) and
// B4 (dk, dv).
//
// Replace the TPU kernels src/repro/kernels/flash_attention.py::_dq_kernel
// and ::_dkv_kernel (entry point flash_attention_bwd). Same function, every
// product and sum in f32 whatever the input type: q is scaled by 1/sqrt(D)
// before QK^T, p = exp(s - lse) where the mask allows and exactly 0 where it
// does not, ds = p * (dp - delta) with dp = dO V^T, and
//   dq = ds K * scale,  dk = ds^T (q * scale),  dv = p^T dO.
// lse (B, Hq, Sq) f32 comes from the forward (kernel B2, flash_attention.cu)
// and delta (B, Hq, Sq) f32 = rowsum(dO * O) from a plain reduction in the
// wrapper, as the TPU wrapper computes it outside its kernels.
//
// What bounds them on the H100: at the training shape (S 4096, D 128) each
// (q tile, k tile) pair is 3 (dq) or 4 (dk, dv) 64x64x128 products on
// 64x128 tiles, ~S/2 multiply-adds per loaded byte, so arithmetic bounds
// them. As K1, this first version runs the products on the f32 FMA units
// (67 TFLOP/s): the f32 path must stay f32, and wgmma is later work.
//
// Design, B3: one block per (batch row, q head, 64-row q tile), 256
// threads; Q and dO tiles stay in shared memory while the block walks the
// key tiles from the window bound to the causal bound (fully masked tiles
// are never loaded, the TPU kernel's pl.when skip). Each thread owns a 4x4
// patch of the score and dp tiles, computed in one pass over D, and a
// 4-row x D/16 patch of the dq accumulator; ds goes through shared memory
// to the ds K product.
//
// Design, B4: one block per (batch row, kv head, 64-row k tile). The block
// keeps its K and V tiles and its dk and dv accumulators (registers) for
// the whole run and loops over the q heads of its GQA group and, inside,
// over the q tiles that can see its keys. The group sum of the TPU wrapper
// (per-q-head f32 partials summed outside the kernel) thus happens in the
// block's registers in a fixed order: no atomics, no partials in device
// memory, and two runs give the same bits. The transposed scores s^T and
// dp^T (4 key rows x 4 query columns per thread) give p^T and ds^T in
// shared memory for the dv += p^T dO and dk += ds^T q products.
//
// Both take any Sq/Sk (the TPU backward silently drops tail rows when its
// blocks do not tile the sequence): keys past Sk and queries past Sq are
// zero-filled and masked, and rows past the end are not stored.
//
// Layouts: q, dO (B, Sq, Hq, D); k, v (B, Sk, Hkv, D); dq like q; dk, dv
// like k; all contiguous. q head h reads kv head h / (Hq / Hkv). Both need
// more than 48 KB of shared memory (smem_opt_in.cuh).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

#include "attn_tile.cuh"
#include "smem_opt_in.cuh"

namespace {

using namespace attn;

template <int D>
constexpr size_t dq_smem_bytes() {  // Q, dO; K, V padded; ds
  return sizeof(float) * (2 * size_t(BQ) * D + 2 * size_t(BK) * (D + 1) + size_t(BQ) * (BK + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // K, V, Q, dO padded; p^T, ds^T; lse, delta
  return sizeof(float) *
         (2 * size_t(BK) * (D + 1) + 2 * size_t(BQ) * (D + 1) + 2 * size_t(BK) * (BQ + 1) + 2 * BQ);
}

template <typename T, int NC>  // head dim D = 16 * NC
__global__ void __launch_bounds__(THREADS)
attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int Hq,
               int Hkv, int causal, int window, float scale) {
  constexpr int D = 16 * NC;
  constexpr int STR = D + 1;    // padded K / V rows: the score loop reads down columns
  constexpr int PSTR = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x D, pre-scaled
  float* dOs = Qs + BQ * D;     // BQ x D
  float* Ks = dOs + BQ * D;     // BK x STR
  float* Vs = Ks + BK * STR;    // BK x STR
  float* dSs = Vs + BK * STR;   // BQ x PSTR

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int rg = tid >> 4;      // rows rg*4 .. rg*4+3
  const int cl = tid & 15;      // columns cl + 16*c

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx - r * D;
    const int qp = q0 + r;
    float qv = 0.f, ov = 0.f;
    if (qp < Sq) {
      const size_t off = ((size_t(b) * Sq + qp) * Hq + h) * D + c;
      qv = to_f32(q[off]) * scale;
      ov = to_f32(dout[off]);
    }
    Qs[idx] = qv;
    dOs[idx] = ov;
  }
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + rg * 4 + r;
    const size_t row = (size_t(b) * Hq + h) * Sq + qp;
    lse_r[r] = qp < Sq ? lse[row] : 0.f;
    delta_r[r] = qp < Sq ? delta[row] : 0.f;
  }

  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's dSs / Ks reads are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx - r * D;
      const int kp = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk) {
        const size_t off = ((size_t(b) * Sk + kp) * Hkv + hk) * D + c;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      Ks[r * STR + c] = kv;
      Vs[r * STR + c] = vv;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qa[r] = Qs[(rg * 4 + r) * D + d];
        oa[r] = dOs[(rg * 4 + r) * D + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kb[c] = Ks[(cl + 16 * c) * STR + d];
        vb[c] = Vs[(cl + 16 * c) * STR + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
          dp[r][c] = fmaf(oa[r], vb[c], dp[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + rg * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = cl + 16 * c;
        const float p = visible(qp, k0 + j, Sk, causal, window) ? expf(s[r][c] - lse_r[r]) : 0.f;
        dSs[(rg * 4 + r) * PSTR + j] = p * (dp[r][c] - delta_r[r]);
      }
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float kb[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kb[c] = Ks[j * STR + cl + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ds = dSs[(rg * 4 + r) * PSTR + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(ds, kb[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + rg * 4 + r;
    if (qp >= Sq) continue;
    T* row = dq + ((size_t(b) * Sq + qp) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[cl + 16 * c] = from_f32<T>(acc[r][c] * scale);
  }
}

template <typename T, int NC>  // head dim D = 16 * NC
__global__ void __launch_bounds__(THREADS)
attn_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq,
                int Sk, int Hq, int Hkv, int causal, int window, float scale) {
  constexpr int D = 16 * NC;
  constexpr int STR = D + 1;    // padded rows: the score loop reads Q and dO down columns
  constexpr int PSTR = BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;             // BK x STR
  float* Vs = Ks + BK * STR;    // BK x STR
  float* Qs = Vs + BK * STR;    // BQ x STR, pre-scaled
  float* dOs = Qs + BQ * STR;   // BQ x STR
  float* Ps = dOs + BQ * STR;   // BK x PSTR: p^T
  float* dSs = Ps + BK * PSTR;  // BK x PSTR: ds^T
  float* lse_s = dSs + BK * PSTR;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int kt = blockIdx.x;    // causal: low key tiles see the most queries, run first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int k0 = kt * BK;
  const int rg = tid >> 4;      // key rows rg*4 .. rg*4+3
  const int cl = tid & 15;      // query columns / head-dim columns cl + 16*c

  for (int idx = tid; idx < BK * D; idx += THREADS) {
    const int r = idx / D, c = idx - r * D;
    const int kp = k0 + r;
    float kv = 0.f, vv = 0.f;
    if (kp < Sk) {
      const size_t off = ((size_t(b) * Sk + kp) * Hkv + hk) * D + c;
      kv = to_f32(k[off]);
      vv = to_f32(v[off]);
    }
    Ks[r * STR + c] = kv;
    Vs[r * STR + c] = vv;
  }

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  // queries that can see keys k0 .. k0+BK-1: from k0 if causal, and below
  // k0 + BK - 1 + window for a causal window
  const int q_begin = causal ? k0 : 0;
  const int q_end = (causal && window > 0) ? min(Sq, k0 + BK - 1 + window) : Sq;
  const int t_begin = q_begin / BQ;
  const int t_end = q_end > q_begin ? (q_end + BQ - 1) / BQ : t_begin;

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // the previous tile's reads of Qs / dOs / Ps / dSs are done
      for (int idx = tid; idx < BQ * D; idx += THREADS) {
        const int r = idx / D, c = idx - r * D;
        const int qp = q0 + r;
        float qv = 0.f, ov = 0.f;
        if (qp < Sq) {
          const size_t off = ((size_t(b) * Sq + qp) * Hq + h) * D + c;
          qv = to_f32(q[off]) * scale;
          ov = to_f32(dout[off]);
        }
        Qs[r * STR + c] = qv;
        dOs[r * STR + c] = ov;
      }
      if (tid < BQ) {
        const int qp = q0 + tid;
        const size_t row = (size_t(b) * Hq + h) * Sq + qp;
        lse_s[tid] = qp < Sq ? lse[row] : 0.f;
        delta_s[tid] = qp < Sq ? delta[row] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];  // transposed: rows are keys, columns queries
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float ka[4], va[4], qb[4], ob[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ka[r] = Ks[(rg * 4 + r) * STR + d];
          va[r] = Vs[(rg * 4 + r) * STR + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qb[c] = Qs[(cl + 16 * c) * STR + d];
          ob[c] = dOs[(cl + 16 * c) * STR + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] = fmaf(ka[r], qb[c], s[r][c]);
            dp[r][c] = fmaf(va[r], ob[c], dp[r][c]);
          }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kp = k0 + rg * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = cl + 16 * c;
          const int qp = q0 + i;
          const float p = (qp < Sq && visible(qp, kp, Sk, causal, window))
                              ? expf(s[r][c] - lse_s[i])
                              : 0.f;
          Ps[(rg * 4 + r) * PSTR + i] = p;
          dSs[(rg * 4 + r) * PSTR + i] = p * (dp[r][c] - delta_s[i]);
        }
      }
      __syncthreads();

      for (int i = 0; i < BQ; ++i) {
        float ob[NC], qb[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          ob[c] = dOs[i * STR + cl + 16 * c];
          qb[c] = Qs[i * STR + cl + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = Ps[(rg * 4 + r) * PSTR + i];
          const float ds = dSs[(rg * 4 + r) * PSTR + i];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv_acc[r][c] = fmaf(p, ob[c], dv_acc[r][c]);
            dk_acc[r][c] = fmaf(ds, qb[c], dk_acc[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kp = k0 + rg * 4 + r;
    if (kp >= Sk) continue;
    const size_t off = ((size_t(b) * Sk + kp) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + cl + 16 * c] = from_f32<T>(dk_acc[r][c]);
      dv[off + cl + 16 * c] = from_f32<T>(dv_acc[r][c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, Hq, Hkv, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int NC>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<16 * NC>();
  static SmemOptIn opt_in;  // one per kernel instance
  cudaError_t err = opt_in_smem(opt_in, attn_dq_kernel<T, NC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
  attn_dq_kernel<T, NC><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), a.Sq, a.Sk, a.Hq,
      a.Hkv, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<16 * NC>();
  static SmemOptIn opt_in;  // one per kernel instance
  cudaError_t err = opt_in_smem(opt_in, attn_dkv_kernel<T, NC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sk + BK - 1) / BK, a.Hkv, a.B);
  attn_dkv_kernel<T, NC><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.Sq, a.Sk, a.Hq, a.Hkv, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int D, bool dkv) {
#define REPRO_BWD_CASE(NC) \
  case 16 * NC: return dkv ? launch_dkv<T, NC>(a) : launch_dq<T, NC>(a);
  switch (D) {  // the head dims of K1 (flash_attention.cu)
    REPRO_BWD_CASE(1)
    REPRO_BWD_CASE(2)
    REPRO_BWD_CASE(4)
    REPRO_BWD_CASE(8)
    REPRO_BWD_CASE(10)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_CASE
}

int run(const Args& a, int D, int dtype, bool dkv) {
  if (a.B <= 0 || (dkv ? a.Sk : a.Sq) <= 0) return cudaSuccess;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0) return cudaErrorInvalidValue;
  cudaError_t err = dtype == 0   ? dispatch<float>(a, D, dkv)
                    : dtype == 1 ? dispatch<__nv_bfloat16>(a, D, dkv)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; lse and delta (B, Hq, Sq) f32. Each
// returns the launch's cudaGetLastError().

// Kernel B3: dq (B, Sq, Hq, D) in q's dtype.
extern "C" int repro_flash_attention_dq(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dq, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                        int causal, int window, float scale, int dtype,
                                        void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         dq, nullptr, nullptr, B, Sq, Sk, Hq, Hkv, causal, window, scale,
         static_cast<cudaStream_t>(stream)};
  return run(a, D, dtype, false);
}

// Kernel B4: dk, dv (B, Sk, Hkv, D) in k's dtype, summed over each GQA group.
extern "C" int repro_flash_attention_dkv(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         void* dk, void* dv, int B, int Sq, int Sk, int Hq,
                                         int Hkv, int D, int causal, int window, float scale,
                                         int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         nullptr, dk, dv, B, Sq, Sk, Hq, Hkv, causal, window, scale,
         static_cast<cudaStream_t>(stream)};
  return run(a, D, dtype, true);
}
