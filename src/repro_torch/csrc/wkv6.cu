// Chunked WKV6, decayed linear attention with a carried (K, V) state: kernel
// B6.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6.py::_wkv_kernel (entry point
// wkv6_fwd). Same function, in f32 whatever the input type: per chunk of
// CHUNK = 64 tokens, p = cumsum(ld) down the chunk and w = p - ld (rwkv6
// mode, with a bonus u on the current token, which does not see itself in
// the state) or w = p (SSD mode, u == null, the token sees itself); the
// intra-chunk scores A[t,s] = sum_k q_tk k_sk e^{w_tk - p_sk}, kept for s < t
// (rwkv6) or s <= t (SSD); o = A v [+ (sum_k q u k) v] + (q e^w) S, written
// in q's type; S <- e^{p_last} S + (k e^{p_last - p})^T v. The scores take
// the rescaled product (q e^w)(k e^-p)^T when the chunk's decay range
// -min(p) is below SAFE_DECAY_RANGE = 30, and the exact per-pair exponent
// otherwise (the reference's masked fallback), chosen per (b, h, chunk) as
// the TPU kernel chooses it. The final state is written in f32.
//
// What bounds it on the H100: per chunk and head it moves c (3K + 2V)
// elements and does about c^2 (K + V) / 2 + 2 c K V multiply-adds, so at
// K = V = 64 in f32 the work is ~20 operations per byte, the card's own
// balance point: both bounds are close (about 2 microseconds at rwkv6-3b's
// prefill), and what sets its time is latency, as the chunks of one head are
// a sequential recurrence. This first version does the products on the f32
// FMA units (the f32 path must stay f32), with no tensor cores and no TMA.
//
// Design: the TPU kernel walks a sequential grid axis over chunks with the
// state in VMEM scratch. Here one block owns a (b, h, 16-column slice of V)
// triple and loops over the chunks itself, its K x 16 slice of the state
// staying in shared memory. The recurrence separates over the columns of V,
// so splitting V into slices of VS = 16 fills more of the 132 SMs (rwkv6
// prefill at B = 1 is 40 heads x 4 slices = 160 blocks, hymba's 25 x 4 =
// 100) at the cost of recomputing the c x c scores in every slice; the
// shared memory (~90 KB at K = 64) lets two blocks share an SM, so 160
// blocks run in one wave. The scores are never a (c, c, K) tensor: the
// fallback computes e^{w_tk - p_sk} on the fly inside the product. Inputs
// are read in their (B, T, H, *) layout through element strides (ld may be a
// broadcast view with stride 0 along K, as SSD's per-head decay is), so the
// wrapper transposes nothing. Any T: the ragged last chunk is masked (k = 0
// and ld = 0 past T, which leave the state as it is, and no row past T is
// stored), where the TPU kernel raises unless the chunk tiles T. K and V up
// to 64.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "smem_opt_in.cuh"

namespace {

constexpr int CHUNK = 64;     // tokens per chunk
constexpr int KMAX = 64;      // largest K (and V) the kernel takes
constexpr int VS = 16;        // V columns per block
constexpr int THREADS = 256;
constexpr int KSTR = KMAX + 1;  // padded rows: the score loop reads down columns
constexpr int ASTR = CHUNK + 1;
constexpr float SAFE_DECAY_RANGE = 30.f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(4) * CHUNK * KSTR      // Q, K, P, W
                          + size_t(CHUNK) * VS          // V slice
                          + size_t(CHUNK) * ASTR        // scores
                          + size_t(KMAX) * VS           // state slice
                          + CHUNK + KMAX + 4 * CHUNK    // diag, u, scan totals
                          + THREADS / 32 + 1);          // min reduction, branch
}

// Element strides of one (B, T, H, X) input.
struct Strides {
  int64_t b, t, h, x;
};

template <typename T, typename TL>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const TL* __restrict__ ld, const float* __restrict__ u, T* __restrict__ o,
            float* __restrict__ state, Strides sq, Strides sk, Strides sv, Strides sl, int T_len,
            int H, int K, int V) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // CHUNK x KSTR: q, then q e^w
  float* Ks = Qs + CHUNK * KSTR;      // k, then k e^{p_last - p}
  float* Ps = Ks + CHUNK * KSTR;      // p = cumsum(ld)
  float* Ws = Ps + CHUNK * KSTR;      // ld, then w, then k e^-p (rescaled path)
  float* Vs = Ws + CHUNK * KSTR;      // CHUNK x VS
  float* As = Vs + CHUNK * VS;        // CHUNK x ASTR
  float* Ss = As + CHUNK * ASTR;      // KMAX x VS
  float* diag = Ss + KMAX * VS;       // CHUNK
  float* us = diag + CHUNK;           // KMAX
  float* seg = us + KMAX;             // 4 x CHUNK segment totals of the scan
  float* red = seg + 4 * CHUNK;       // THREADS / 32 partial minima, then the branch

  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * VS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool use_u = u != nullptr;
  const int rg = tid >> 4;            // score rows rg*4 .. rg*4+3 / output rows
  const int cl = tid & 15;            // score columns cl + 16*j / output column

  for (int i = tid; i < KMAX * VS; i += THREADS) Ss[i] = 0.f;
  if (use_u)
    for (int i = tid; i < K; i += THREADS) us[i] = u[size_t(h) * K + i];

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const TL* lb = ld + b * sl.b + h * sl.h;

  for (int t0 = 0; t0 < T_len; t0 += CHUNK) {
    __syncthreads();  // the previous chunk's reads of every buffer are done
    // ---- load the chunk; rows past T are zero (k = 0, ld = 0)
    for (int idx = tid; idx < CHUNK * K; idx += THREADS) {
      const int t = idx / K, x = idx - t * K;
      const int pos = t0 + t;
      float qv = 0.f, kv = 0.f, lv = 0.f;
      if (pos < T_len) {
        qv = to_f32(qb[pos * sq.t + x * sq.x]);
        kv = to_f32(kb[pos * sk.t + x * sk.x]);
        lv = to_f32(lb[pos * sl.t + x * sl.x]);
      }
      Qs[t * KSTR + x] = qv;
      Ks[t * KSTR + x] = kv;
      Ws[t * KSTR + x] = lv;
    }
    for (int idx = tid; idx < CHUNK * VS; idx += THREADS) {
      const int t = idx / VS, j = idx - t * VS;
      const int pos = t0 + t, col = v0 + j;
      Vs[idx] = (pos < T_len && col < V) ? to_f32(vb[pos * sv.t + col * sv.x]) : 0.f;
    }
    __syncthreads();

    // ---- p = cumsum(ld) down the chunk: 4 segments of 16 rows per column
    float pmin = 0.f;
    const int col = tid % KMAX, sg = tid / KMAX;  // sg in 0..3
    float run[16];
    if (col < K) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        acc += Ws[(sg * 16 + r) * KSTR + col];
        run[r] = acc;
      }
      seg[sg * CHUNK + col] = acc;
    }
    __syncthreads();
    if (col < K) {
      float off = 0.f;
      for (int g = 0; g < sg; ++g) off += seg[g * CHUNK + col];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int t = sg * 16 + r;
        const float p = off + run[r];
        const float l = Ws[t * KSTR + col];
        Ps[t * KSTR + col] = p;
        Ws[t * KSTR + col] = use_u ? p - l : p;
        pmin = fminf(pmin, p);
      }
    }
    // the chunk's decay range -min(p), over every row and column
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      pmin = fminf(pmin, __shfl_xor_sync(0xffffffffu, pmin, off));
    if ((tid & 31) == 0) red[tid >> 5] = pmin;
    __syncthreads();
    if (tid == 0) {
      float m = red[0];
      for (int i = 1; i < THREADS / 32; ++i) m = fminf(m, red[i]);
      red[THREADS / 32] = (-m < SAFE_DECAY_RANGE) ? 1.f : 0.f;
    }
    // the bonus diagonal sum_k q u k, from the raw q and k
    if (use_u && tid < CHUNK) {
      float d = 0.f;
      for (int x = 0; x < K; ++x) d = fmaf(Qs[tid * KSTR + x] * us[x], Ks[tid * KSTR + x], d);
      diag[tid] = d;
    }
    __syncthreads();
    const bool rescaled = red[THREADS / 32] != 0.f;

    // ---- intra-chunk scores, a 4 x 4 patch per thread
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    if (rescaled) {
      // q <- q e^w, Ws <- k e^-p (w is read before it is replaced: the same
      // thread owns both elements)
      for (int idx = tid; idx < CHUNK * K; idx += THREADS) {
        const int i = (idx / K) * KSTR + idx % K;
        Qs[i] *= expf(Ws[i]);
        Ws[i] = Ks[i] * expf(-Ps[i]);
      }
      __syncthreads();
      for (int x = 0; x < K; ++x) {
        float qa[4], kc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[r] = Qs[(rg * 4 + r) * KSTR + x];
#pragma unroll
        for (int c = 0; c < 4; ++c) kc[c] = Ws[(cl + 16 * c) * KSTR + x];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], kc[c], s[r][c]);
      }
    } else {
      // exact per-pair decay e^{w_tk - p_sk} <= 1 on the kept pairs
      for (int x = 0; x < K; ++x) {
        float qa[4], wa[4], kc[4], pc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qa[r] = Qs[(rg * 4 + r) * KSTR + x];
          wa[r] = Ws[(rg * 4 + r) * KSTR + x];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kc[c] = Ks[(cl + 16 * c) * KSTR + x];
          pc[c] = Ps[(cl + 16 * c) * KSTR + x];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int t = rg * 4 + r, sc = cl + 16 * c;
            const bool keep = use_u ? sc < t : sc <= t;
            const float e = keep ? expf(wa[r] - pc[c]) : 0.f;
            s[r][c] = fmaf(qa[r] * kc[c], e, s[r][c]);
          }
      }
      __syncthreads();  // every thread's reads of the raw q and w are done
      for (int idx = tid; idx < CHUNK * K; idx += THREADS) {
        const int i = (idx / K) * KSTR + idx % K;
        Qs[i] *= expf(Ws[i]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int t = rg * 4 + r, sc = cl + 16 * c;
        const bool keep = use_u ? sc < t : sc <= t;
        As[t * ASTR + sc] = keep ? s[r][c] : 0.f;
      }
    __syncthreads();

    // ---- o = A v [+ diag v] + (q e^w) S for rows rg*4 .. +3, column cl;
    // meanwhile k <- k e^{p_last - p} for the state update (Ks is not read here)
    float acc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] = 0.f;
    for (int sidx = 0; sidx < CHUNK; ++sidx) {
      const float vv = Vs[sidx * VS + cl];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = fmaf(As[(rg * 4 + r) * ASTR + sidx], vv, acc[r]);
    }
    for (int x = 0; x < K; ++x) {
      const float sv_ = Ss[x * VS + cl];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = fmaf(Qs[(rg * 4 + r) * KSTR + x], sv_, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = rg * 4 + r;
      float val = acc[r];
      if (use_u) val = fmaf(diag[t], Vs[t * VS + cl], val);
      const int pos = t0 + t, c = v0 + cl;
      if (pos < T_len && c < V)
        o[((size_t(b) * T_len + pos) * H + h) * V + c] = from_f32<T>(val);
    }
    for (int idx = tid; idx < CHUNK * K; idx += THREADS) {
      const int t = idx / K, x = idx - t * K;
      const int i = t * KSTR + x;
      Ks[i] *= expf(Ps[(CHUNK - 1) * KSTR + x] - Ps[i]);
    }
    __syncthreads();

    // ---- S <- e^{p_last} S + (k e^{p_last - p})^T v, 4 rows of K per thread
    for (int x = rg; x < K; x += THREADS / VS) {
      float a = expf(Ps[(CHUNK - 1) * KSTR + x]) * Ss[x * VS + cl];
      for (int t = 0; t < CHUNK; ++t) a = fmaf(Ks[t * KSTR + x], Vs[t * VS + cl], a);
      Ss[x * VS + cl] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < K * VS; idx += THREADS) {
    const int x = idx / VS, j = idx - x * VS;
    if (v0 + j < V) state[((size_t(b) * H + h) * K + x) * V + v0 + j] = Ss[x * VS + j];
  }
}

template <typename T, typename TL>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ld, const float* u,
                   void* o, float* state, Strides sq, Strides sk, Strides sv, Strides sl, int B,
                   int T_len, int H, int K, int V, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes();
  static SmemOptIn opt_in;  // one per kernel instance
  cudaError_t err = opt_in_smem(opt_in, wkv6_kernel<T, TL>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((V + VS - 1) / VS, H, B);
  wkv6_kernel<T, TL><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TL*>(ld), u, static_cast<T*>(o), state, sq, sk, sv, sl, T_len, H, K, V);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_ld(const void* q, const void* k, const void* v, const void* ld,
                        const float* u, void* o, float* state, Strides sq, Strides sk,
                        Strides sv, Strides sl, int B, int T_len, int H, int K, int V,
                        int ld_dtype, cudaStream_t s) {
  return ld_dtype == 0 ? launch<T, float>(q, k, v, ld, u, o, state, sq, sk, sv, sl, B, T_len, H,
                                          K, V, s)
         : ld_dtype == 1 ? launch<T, __nv_bfloat16>(q, k, v, ld, u, o, state, sq, sk, sv, sl, B,
                                                    T_len, H, K, V, s)
                         : cudaErrorInvalidValue;
}

}  // namespace

// Kernel B6. q, k, ld (B, T, H, K) and v (B, T, H, V) read through element
// strides (the four of each: b, t, h, last); u (H, K) f32 contiguous, or
// null for SSD mode; o (B, T, H, V) contiguous in q's type; state (B, H, K,
// V) f32 contiguous, written whole. dtype (of q, k, v, o) and ld_dtype: 0 =
// float32, 1 = bfloat16. Returns the launch's cudaGetLastError(); with an
// empty grid it launches nothing and returns 0 (the caller fills the state).
extern "C" int repro_wkv6_fwd(const void* q, const void* k, const void* v, const void* ld,
                              const void* u, void* o, void* state, const int64_t* strides, int B,
                              int T_len, int H, int K, int V, int dtype, int ld_dtype,
                              void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0) return 0;
  if (K <= 0 || K > KMAX || V <= 0 || V > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{strides[0], strides[1], strides[2], strides[3]};
  const Strides sk{strides[4], strides[5], strides[6], strides[7]};
  const Strides sv{strides[8], strides[9], strides[10], strides[11]};
  const Strides sl{strides[12], strides[13], strides[14], strides[15]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  float* st = static_cast<float*>(state);
  cudaError_t err =
      dtype == 0 ? dispatch_ld<float>(q, k, v, ld, uf, o, st, sq, sk, sv, sl, B, T_len, H, K, V,
                                      ld_dtype, s)
      : dtype == 1 ? dispatch_ld<__nv_bfloat16>(q, k, v, ld, uf, o, st, sq, sk, sv, sl, B, T_len,
                                                H, K, V, ld_dtype, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
