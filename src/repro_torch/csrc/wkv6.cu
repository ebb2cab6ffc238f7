// Chunked WKV6, decayed linear attention with a carried (K, V) state, on
// Hopper's tensor cores: kernel B6.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6.py::_wkv_kernel (entry point
// wkv6_fwd). Same function, in f32 whatever the input type: per chunk of
// CHUNK = 64 tokens, p = cumsum(ld) down the chunk and w = p - ld (rwkv6
// mode, with a bonus u on the current token, which does not see itself in
// the state) or w = p (SSD mode, u == null, the token sees itself); the
// intra-chunk scores A[t,s] = sum_k q_tk k_sk e^{w_tk - p_sk}, kept for s < t
// (rwkv6) or s <= t (SSD); o = A v [+ (sum_k q u k) v] + (q e^w) S, written
// in q's type; S <- e^{p_last} S + (k e^{p_last - p})^T v, written in f32.
//
// What bounds it on the H100: per chunk and head it moves c (3K + 2V)
// elements and does about c^2 (K + V) / 2 + 2 c K V multiply-adds, ~20
// operations per byte in f32, the card's balance point: both bounds are
// about 2 microseconds at rwkv6-3b's prefill. What sets its time is the
// chain of dependent steps inside each chunk, as the chunks of one head are
// a sequential recurrence. The design shortens that chain:
//  - the next chunk's inputs are copied into a second buffer while this
//    chunk computes, so no load sits in front of a barrier: one
//    copy-engine (bulk) copy per row, completing on the buffer's mbarrier,
//    where a row is contiguous, 16-byte aligned and a multiple of 16 bytes
//    of at least 128 (5% faster than 16-byte cp.async at rwkv6-3b's shape,
//    PERF.md); else 16- or 4-byte cp.async, and plain loads for bf16 at a
//    stride;
//  - p = cumsum(ld) is a shuffle scan inside one warp per 4 columns (each
//    lane holds rows l and l + 32), which also hands the warp every
//    sub-block boundary of its columns, so the scaled operands and all
//    decay factors come out of the same pass with no barrier in between;
//  - all four products run on mma.sync m16n8k8 as 3xTF32 (hi = tf32(x), lo
//    = tf32(x - hi); lo*hi + hi*lo, then hi*hi): the scores (c x c x K), A v,
//    (q e^w) S and (k e^{p_last - p})^T v, each in its own accumulator and
//    folded with f32 adds (an mma's accumulation drifts over long sums,
//    PERF.md); bf16 inputs are computed in f32 the same way;
//  - three barriers a chunk: inputs arrived, scaled operands ready, scores
//    ready.
//
// The scores without overflow, on the tensor cores whatever the decay: the
// chunk is cut into four sub-blocks of 16 rows, with r^s_i = p at the row
// before sub-block i (0 for the first), r^e_i = p at its last row and m_i
// = p at its row 8. Stored once per chunk: Q^_t = q_t e^{w_t - r^s_i(t)}
// and K^_s = k_s e^{r^e_i(s) - p_s}. With ld <= 0 (both models clamp it
// below 0) p falls down the chunk, so both are <= 1.
//  - Off-diagonal pair of sub-blocks i > j: A_ts = sum_k (Q^_tk
//    e^{r^s_ik - r^e_jk}) K^_sk, the first factor <= 1 as r^s_i <= r^e_j.
//    Both operands are <= 1: nothing overflows, and an operand that
//    underflows drops a term that is below f32's range itself.
//  - Diagonal sub-block i: (Q^_t e^{r^s_i - m_i}) (K^_s e^{m_i - r^e_i}),
//    both factors at most e^30 while each half of the sub-block spans a
//    decay range below the reference's bound of 30, with the mask applied
//    to the product; otherwise (a sub-block past a range of 60 over 16
//    tokens) that tile takes the exact per-pair exponent e^{w_tk - p_sk}
//    on the FMA units.
// In real arithmetic this is the reference's function in both of its
// branches; only the rounding differs (ROADMAP.md, section C). The other
// products take the same operands with a factor per (sub-block, column):
// q e^w = Q^ e^{r^s}, k e^{p_last - p} = K^ e^{p_last - r^e}.
//
// Design: one block per (b, h, slice of VS columns of V), 8 warps, looping
// over the chunks with its K x VS slice of the state in registers (the
// warps that own it) and in shared memory (for the next chunk's (q e^w) S).
// Per chunk: stage A (after the inputs arrive): each warp scans its column
// quads and writes Q^, K^, p and the per-column decay factors; stage B:
// (q e^w) S and the state product for the warp's tiles, and the score tiles
// (the 8 diagonal n-tiles one per warp, the 12 off-diagonal ones spread);
// stage C: A v for the warp's output tile, o = (q e^w) S + A v + bonus, and
// the new state into shared memory. The launcher picks VS in {16, 32, 64}
// from B * H and the shared memory a block needs: the narrowest whose
// blocks are all resident at once (rwkv6-3b and hymba-1.5b at batch 1: 32
// and 16; 64 and 16 were slower for rwkv6, 32 and 64 for hymba, PERF.md),
// though the scores are recomputed in every slice. Inputs are read in their (B, T, H, *)
// layout through element strides (ld may be a broadcast view with stride 0
// along K, as SSD's per-head decay is), so the wrapper transposes nothing.
// Any T: the ragged last chunk is zero-filled by the copy (k = 0 and ld =
// 0 past T leave the state as it is) and no row past T is stored, where the
// TPU kernel raises unless the chunk tiles T. K and V up to 64. No atomics
// on data: two runs give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "mma.cuh"
#include "smem_opt_in.cuh"

namespace {

constexpr int CHUNK = 64;      // tokens per chunk
constexpr int SUB = 16;        // rows per sub-block
constexpr int NSUB = CHUNK / SUB;
constexpr int KMAX = 64;       // largest K (and V) the kernel takes
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LA = CHUNK + 4;  // row stride of the scores (conflict-free A fragments)
constexpr int FSTR = KMAX + 4; // row stride of the factor table
constexpr float SAFE_DECAY_RANGE = 30.f;

// Rows of the per-column factor table, filled in stage A.
constexpr int F_OFF = 0;   // 6: e^{r^s_i - r^e_j}, pair (i, j < i) at i (i - 1) / 2 + j
constexpr int F_QD = 6;    // 4: e^{r^s_i - m_i}, diagonal sub-block's q side
constexpr int F_KD = 10;   // 4: e^{m_i - r^e_i}, its k side
constexpr int F_QS = 14;   // 4: e^{r^s_i}, q e^w = Q^ e^{r^s}
constexpr int F_KS = 18;   // 4: e^{p_last - r^e_i}, k e^{p_last - p} = K^ e^{p_last - r^e}
constexpr int F_DEC = 22;  // e^{p_last}, the state's decay over the chunk
constexpr int NF = 23;

// How a block stages one input's rows (chosen per input by the launcher):
// plain loads, 4- or 16-byte cp.async, or one copy-engine copy per row.
enum CopyMode : int { COPY_SYNC = 0, COPY_4 = 1, COPY_16 = 2, COPY_BULK = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive staged elements as f32; columns at or past n read 0.
__device__ __forceinline__ void load_quad(const float* p, int c, int n, float (&out)[4]) {
  if (c + 4 <= n) {
    const float4 v = *reinterpret_cast<const float4*>(p + c);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = c + j < n ? p[c + j] : 0.f;
  }
}
__device__ __forceinline__ void load_quad(const __nv_bfloat16* p, int c, int n, float (&out)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p + c);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = lo.x, out[1] = lo.y, out[2] = hi.x, out[3] = hi.y;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j >= n) out[j] = 0.f;
}

// Element strides of one (B, T, H, X) input.
struct Strides {
  int64_t b, t, h, x;
};

// Shared-memory layout of one launch (host-computed, passed by value). Raw
// rows are padded to a 16-byte multiple plus 16 bytes, so a quarter warp
// reading 16 bytes from each of 8 consecutive rows hits distinct banks.
struct Layout {
  int rk, rl, rv;     // raw row strides (elements) of q and k, ld, v
  int ld, ls;         // f32 row strides of Q^ / K^ / p, and of S
  int kp;             // K rounded up to 16 (the products' padded depth)
  int stage;          // bytes of one raw stage: q, k, ld, v
  int q_off, k_off, l_off, v_off;  // byte offsets inside a stage
  int qh, kh, p, as, s, f, dp, u, flags;  // byte offsets of the f32 arrays
  int bars;           // byte offset of the two raw stages' mbarriers
  int bytes;
};

int round_up(int x, int m) { return (x + m - 1) / m * m; }

Layout make_layout(int K, int VS, int es, int esl) {
  Layout L{};
  L.rk = round_up(K, 16 / es) + 16 / es;
  L.rl = round_up(K, 16 / esl) + 16 / esl;
  L.rv = VS + 8;  // f32: 8 mod 32 words, bf16: 4 mod 16: B fragments conflict-free
  L.kp = round_up(K, 16);
  L.ld = L.kp + 4;
  L.ls = VS + 8;
  L.q_off = 0;
  L.k_off = CHUNK * L.rk * es;
  L.l_off = 2 * CHUNK * L.rk * es;
  L.v_off = L.l_off + CHUNK * L.rl * esl;
  L.stage = L.v_off + CHUNK * L.rv * es;
  int off = 2 * L.stage;
  auto take = [&](int bytes) { const int at = off; off += round_up(bytes, 16); return at; };
  L.qh = take(4 * CHUNK * L.ld);
  L.kh = take(4 * CHUNK * L.ld);
  L.p = take(4 * CHUNK * L.ld);
  L.as = take(4 * CHUNK * LA);
  L.s = take(4 * KMAX * L.ls);
  L.f = take(4 * NF * FSTR);
  L.dp = take(4 * (KMAX / 4) * CHUNK);
  L.u = take(4 * KMAX);
  L.flags = take(16);
  L.bars = take(16);
  L.bytes = off;
  return L;
}

// Rows t0 .. t0 + 63 (zero past T), columns c0 .. c0 + ncols - 1 (zero at or
// past C) of one (b, h) input into a raw stage of row stride rs, by the
// whole block. COPY_16 and COPY_4 are asynchronous (cp.async, committed by
// the caller); COPY_SYNC loads and stores.
template <typename E>
__device__ __forceinline__ void stage_rows(E* dst, int rs, const E* src, const Strides& st,
                                           int t0, int T_len, int c0, int ncols, int C,
                                           int mode, int tid) {
  if (mode == COPY_16) {
    constexpr int PER = 16 / sizeof(E);
    const int nch = (ncols + PER - 1) / PER;
    for (int idx = tid; idx < CHUNK * nch; idx += THREADS) {
      const int r = idx / nch, x = (idx - r * nch) * PER;
      const int n = t0 + r < T_len ? max(0, min(PER, C - c0 - x)) : 0;
      const E* s = n ? src + (t0 + r) * st.t + (c0 + x) : src;
      mma::cp_async16_n(dst + r * rs + x, s, n * int(sizeof(E)));
    }
  } else if (mode == COPY_4) {
    constexpr int PER = 4 / sizeof(E);
    const int nch = (ncols + PER - 1) / PER;
    for (int idx = tid; idx < CHUNK * nch; idx += THREADS) {
      const int r = idx / nch, x = (idx - r * nch) * PER;
      const int n = t0 + r < T_len ? max(0, min(PER, C - c0 - x)) : 0;
      const E* s = n ? src + (t0 + r) * st.t + (c0 + x) * st.x : src;
      mma::cp_async4_n(dst + r * rs + x, s, n * int(sizeof(E)));
    }
  } else {
    for (int idx = tid; idx < CHUNK * ncols; idx += THREADS) {
      const int r = idx / ncols, x = idx - r * ncols;
      const bool ok = t0 + r < T_len && c0 + x < C;
      dst[r * rs + x] = ok ? src[(t0 + r) * st.t + (c0 + x) * st.x] : from_f32<E>(0.f);
    }
  }
}

// With COPY_BULK, row r of the chunk (thread r of a group of 64) as one
// copy-engine copy of `bytes` counted on `bar`, or zeros past T.
template <typename E>
__device__ __forceinline__ void bulk_row(E* dst, int rs, const E* src, const Strides& st, int t0,
                                         int nv, int c0, int bytes, int r, uint64_t* bar) {
  if (r < nv) {
    mma::fence_proxy_async();
    mma::bulk_copy(dst + r * rs, src + (t0 + r) * st.t + c0, bytes, bar);
  } else {
    for (int x = 0; x < bytes / int(sizeof(E)); ++x) dst[r * rs + x] = from_f32<E>(0.f);
  }
}

// acc[N][4] += A B over nk k-steps of 8 in 3xTF32 (mma.cuh), A 16 x 8nk
// from fa(row, k) and B 8nk x 8N from fb(k, n), both in f32. The small
// terms enter each accumulator before the large one.
template <int N, class FA, class FB>
__device__ __forceinline__ void mma_3x(float (&acc)[N][4], int nk, FA fa, FB fb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int ks = 0; ks < nk; ++ks) {
    const int k0 = ks * 8;
    const float av[4] = {fa(g, k0 + t), fa(g + 8, k0 + t), fa(g, k0 + t + 4),
                         fa(g + 8, k0 + t + 4)};
    uint32_t ahi[4], alo[4];
    mma::split4(ahi, alo, av);
    mma::Tf32Pair b0[N], b1[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      b0[i] = mma::split_tf32(fb(k0 + t, 8 * i + g));
      b1[i] = mma::split_tf32(fb(k0 + t + 4, 8 * i + g));
    }
    mma::mma_3xtf32(acc, acc, ahi, alo, b0, b1);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// NV: 8-column tiles of V per block (VS = 8 NV); each warp's output and
// state tiles span NV / 2 of them.
template <typename T, typename TL, int NV>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const TL* __restrict__ ld, const float* __restrict__ u, T* __restrict__ o,
            float* __restrict__ state, Strides sq, Strides sk, Strides sv, Strides sl,
            int4 modes, int T_len, int H, int K, int V, Layout L) {
  constexpr int VS = 8 * NV;
  constexpr int NH = NV / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qh = reinterpret_cast<float*>(smem + L.qh);
  float* Kh = reinterpret_cast<float*>(smem + L.kh);
  float* Ps = reinterpret_cast<float*>(smem + L.p);
  float* As = reinterpret_cast<float*>(smem + L.as);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* Fs = reinterpret_cast<float*>(smem + L.f);
  float* Dp = reinterpret_cast<float*>(smem + L.dp);   // bonus partials, per column quad
  float* us = reinterpret_cast<float*>(smem + L.u);
  int* flags = reinterpret_cast<int*>(smem + L.flags);  // bit i: diagonal sub-block i exact

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int v0 = blockIdx.x * VS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool use_u = u != nullptr;
  const int kp = L.kp, LD = L.ld, LS = L.ls;
  const int ks_k = kp / 8;          // k steps over K
  const int nquad = kp / 4;         // column quads stage A writes (zeros past K)
  const int kq = (K + 3) / 4;       // quads that hold data (bonus partials)

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const TL* lb = ld + b * sl.b + h * sl.h;

  auto raw_q = [&](int buf) { return reinterpret_cast<T*>(smem + buf * L.stage + L.q_off); };
  auto raw_k = [&](int buf) { return reinterpret_cast<T*>(smem + buf * L.stage + L.k_off); };
  auto raw_l = [&](int buf) { return reinterpret_cast<TL*>(smem + buf * L.stage + L.l_off); };
  auto raw_v = [&](int buf) { return reinterpret_cast<T*>(smem + buf * L.stage + L.v_off); };
  // bulk inputs: one row per thread (input tid / 64, row tid % 64), their
  // bytes declared on the stage's mbarrier by thread 0; the rest cp.async
  const int vbytes = min(VS, V - v0) * int(sizeof(T));
  const int row_bytes = (modes.x == COPY_BULK ? K * int(sizeof(T)) : 0) +
                        (modes.y == COPY_BULK ? K * int(sizeof(T)) : 0) +
                        (modes.w == COPY_BULK ? K * int(sizeof(TL)) : 0) +
                        (modes.z == COPY_BULK ? vbytes : 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  auto stage_chunk = [&](int buf, int t0) {
    const int nv = min(CHUNK, T_len - t0), in = tid >> 6, r = tid & 63;
    if (row_bytes && tid == 0) mma::mbar_arrive_expect(&bars[buf], uint32_t(nv * row_bytes));
    if (modes.x == COPY_BULK) {
      if (in == 0) bulk_row(raw_q(buf), L.rk, qb, sq, t0, nv, 0, K * int(sizeof(T)), r, &bars[buf]);
    } else {
      stage_rows(raw_q(buf), L.rk, qb, sq, t0, T_len, 0, K, K, modes.x, tid);
    }
    if (modes.y == COPY_BULK) {
      if (in == 1) bulk_row(raw_k(buf), L.rk, kb, sk, t0, nv, 0, K * int(sizeof(T)), r, &bars[buf]);
    } else {
      stage_rows(raw_k(buf), L.rk, kb, sk, t0, T_len, 0, K, K, modes.y, tid);
    }
    if (modes.w == COPY_BULK) {
      if (in == 2) bulk_row(raw_l(buf), L.rl, lb, sl, t0, nv, 0, K * int(sizeof(TL)), r, &bars[buf]);
    } else {
      stage_rows(raw_l(buf), L.rl, lb, sl, t0, T_len, 0, K, K, modes.w, tid);
    }
    if (modes.z == COPY_BULK) {
      if (in == 3) bulk_row(raw_v(buf), L.rv, vb, sv, t0, nv, v0, vbytes, r, &bars[buf]);
    } else {
      stage_rows(raw_v(buf), L.rv, vb, sv, t0, T_len, v0, VS, V, modes.z, tid);
    }
    mma::cp_async_commit();
  };

  // this warp's output tile (rows 16 rb, NH n-tiles from n0) and state tile
  // (k rows 16 kb, the same columns)
  const int rb = warp >> 1, n0 = (warp & 1) * NH * 8;
  const bool owns_state = rb * 16 < kp;
  float S_reg[NH][4];
  zero(S_reg);
  for (int i = tid; i < KMAX * LS; i += THREADS) Ss[i] = 0.f;
  if (use_u)
    for (int i = tid; i < KMAX; i += THREADS) us[i] = i < K ? u[size_t(h) * K + i] : 0.f;
  if (tid == 0) {
    *flags = 0;
    mma::mbar_init(&bars[0], 1);
    mma::mbar_init(&bars[1], 1);
    mma::mbar_fence_init();
  }
  __syncthreads();  // the mbarriers are initialised

  stage_chunk(0, 0);
  int buf = 0;
  for (int t0 = 0; t0 < T_len; t0 += CHUNK, buf ^= 1) {
    mma::cp_async_wait<0>();
    if (row_bytes) mma::mbar_wait(&bars[buf], (t0 / CHUNK >> 1) & 1);
    __syncthreads();  // (1) this chunk's inputs are in; the previous chunk is done
    if (t0 + CHUNK < T_len) stage_chunk(buf ^ 1, t0 + CHUNK);
    const T* Rq = raw_q(buf);
    const T* Rk = raw_k(buf);
    const TL* Rl = raw_l(buf);
    const T* Rv = raw_v(buf);

    // ---- stage A: per column quad, p by a shuffle scan, Q^, K^, p, factors
    for (int cq = warp; cq < nquad; cq += WARPS) {
      const int c = cq * 4;
      float x[4], y[4], qa[2][4], ka[2][4];
      load_quad(Rl + lane * L.rl, c, K, x);
      load_quad(Rl + (lane + 32) * L.rl, c, K, y);
      load_quad(Rq + lane * L.rk, c, K, qa[0]);
      load_quad(Rq + (lane + 32) * L.rk, c, K, qa[1]);
      load_quad(Rk + lane * L.rk, c, K, ka[0]);
      load_quad(Rk + (lane + 32) * L.rk, c, K, ka[1]);
      const float l0[4] = {x[0], x[1], x[2], x[3]}, l1[4] = {y[0], y[1], y[2], y[3]};
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = __shfl_up_sync(0xffffffffu, x[j], off);
          const float e = __shfl_up_sync(0xffffffffu, y[j], off);
          if (lane >= off) x[j] += a, y[j] += e;
        }
      float rs[4][NSUB], re[4][NSUB], mid[4][NSUB];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        y[j] += __shfl_sync(0xffffffffu, x[j], 31);
        mid[j][0] = __shfl_sync(0xffffffffu, x[j], 7);
        re[j][0] = __shfl_sync(0xffffffffu, x[j], 15);
        mid[j][1] = __shfl_sync(0xffffffffu, x[j], 23);
        re[j][1] = __shfl_sync(0xffffffffu, x[j], 31);
        mid[j][2] = __shfl_sync(0xffffffffu, y[j], 7);
        re[j][2] = __shfl_sync(0xffffffffu, y[j], 15);
        mid[j][3] = __shfl_sync(0xffffffffu, y[j], 23);
        re[j][3] = __shfl_sync(0xffffffffu, y[j], 31);
        rs[j][0] = 0.f, rs[j][1] = re[j][0], rs[j][2] = re[j][1], rs[j][3] = re[j][2];
      }
      float dsum[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = lane + 32 * half;
        const bool upper = lane >= 16;  // sub-block 2 half + upper
        float qo[4], ko[4], po[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = half ? y[j] : x[j];
          const float w = use_u ? p - (half ? l1[j] : l0[j]) : p;
          const float r_s = upper ? rs[j][2 * half + 1] : rs[j][2 * half];
          const float r_e = upper ? re[j][2 * half + 1] : re[j][2 * half];
          qo[j] = qa[half][j] * expf(w - r_s);
          ko[j] = ka[half][j] * expf(r_e - p);
          po[j] = p;
          if (use_u) dsum[half] = fmaf(qa[half][j] * us[c + j], ka[half][j], dsum[half]);
        }
        *reinterpret_cast<float4*>(Qh + t * LD + c) = make_float4(qo[0], qo[1], qo[2], qo[3]);
        *reinterpret_cast<float4*>(Kh + t * LD + c) = make_float4(ko[0], ko[1], ko[2], ko[3]);
        *reinterpret_cast<float4*>(Ps + t * LD + c) = make_float4(po[0], po[1], po[2], po[3]);
      }
      if (use_u && cq < kq) {
        Dp[cq * CHUNK + lane] = dsum[0];
        Dp[cq * CHUNK + lane + 32] = dsum[1];
      }
      // the factor table: lane f < NF computes row f for the quad's columns
      if (lane < NF) {
        float fv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float e = 0.f;  // the exponent of row `lane`, selected with constant indices
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            if (lane != f) continue;
            if (f < F_QD) {
              const int i = f < 1 ? 1 : f < 3 ? 2 : 3;
              e = rs[j][i] - re[j][f - i * (i - 1) / 2];
            } else if (f < F_KD) {
              e = rs[j][f - F_QD] - mid[j][f - F_QD];
            } else if (f < F_QS) {
              e = mid[j][f - F_KD] - re[j][f - F_KD];
            } else if (f < F_KS) {
              e = rs[j][f - F_QS];
            } else if (f < F_DEC) {
              e = re[j][NSUB - 1] - re[j][f - F_KS];
            } else {
              e = re[j][NSUB - 1];
            }
          }
          fv[j] = expf(e);
        }
        *reinterpret_cast<float4*>(Fs + lane * FSTR + c) = make_float4(fv[0], fv[1], fv[2], fv[3]);
      }
      // diagonal sub-blocks whose halves pass the range bound take the exact path
      int bad = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < NSUB; ++i)
          if (rs[j][i] - mid[j][i] >= SAFE_DECAY_RANGE || mid[j][i] - re[j][i] >= SAFE_DECAY_RANGE)
            bad |= 1 << i;
      if (lane == 0 && bad) atomicOr(flags, bad);
    }
    __syncthreads();  // (2) Q^, K^, p, factors and flags are ready

    // ---- stage B: (q e^w) S and the state product for this warp's tiles
    float oq[NH][4];
    zero(oq);
    if (t0 > 0) {
      const float* fq = Fs + (F_QS + rb) * FSTR;
      const float* qrow = Qh + rb * 16 * LD;
      mma_3x(oq, ks_k, [&](int r, int c) { return qrow[r * LD + c] * fq[c]; },
             [&](int c, int n) { return Ss[c * LS + n0 + n]; }, lane);
    }
    if (owns_state) {
      float sp[NH][4];
      zero(sp);
      const int k0 = rb * 16;
      // A = (K^ e^{p_last - r^e})^T: rows are k, columns t (the k steps)
      mma_3x(sp, CHUNK / 8,
             [&](int r, int c) {
               return Kh[c * LD + k0 + r] * Fs[(F_KS + (c >> 4)) * FSTR + k0 + r];
             },
             [&](int c, int n) { return to_f32(Rv[c * L.rv + n0 + n]); }, lane);
      const float d0 = Fs[F_DEC * FSTR + k0 + g], d1 = Fs[F_DEC * FSTR + k0 + g + 8];
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        S_reg[i][0] = fmaf(d0, S_reg[i][0], sp[i][0]);
        S_reg[i][1] = fmaf(d0, S_reg[i][1], sp[i][1]);
        S_reg[i][2] = fmaf(d1, S_reg[i][2], sp[i][2]);
        S_reg[i][3] = fmaf(d1, S_reg[i][3], sp[i][3]);
      }
    }

    // ---- stage B: score tiles. Diagonal n-tile `warp` (sub-block warp / 2,
    // columns 8 (warp & 1) of it), then the off-diagonal ones o = 7 - warp
    // and o + 8.
    const int fl = *flags;
    for (int item = 0; item < 3; ++item) {
      int i, j, nh, pair = -1;
      if (item == 0) {
        i = warp >> 1, j = i, nh = warp & 1;
      } else {
        const int od = 7 - warp + 8 * (item - 1);
        if (od >= 12) break;
        pair = od >> 1;
        i = pair < 1 ? 1 : pair < 3 ? 2 : 3;
        j = pair - i * (i - 1) / 2;
        nh = od & 1;
      }
      const int r0 = i * SUB, s0 = j * SUB + nh * 8;
      float acc[1][4];
      zero(acc);
      const bool diag = pair < 0;
      if (diag && (fl >> i & 1)) {
        // exact per-pair exponent: the sub-block spans too wide a decay range
        // to rescale within it
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = r0 + g + (e >> 1) * 8, s = s0 + 2 * t4 + (e & 1);
          const bool keep = use_u ? s < t : s <= t;
          float a = 0.f;
          if (keep)
            for (int x = 0; x < K; ++x) {
              const float w = Ps[t * LD + x] - (use_u ? to_f32(Rl[t * L.rl + x]) : 0.f);
              a = fmaf(to_f32(Rq[t * L.rk + x]) * to_f32(Rk[s * L.rk + x]),
                       expf(w - Ps[s * LD + x]), a);
            }
          acc[0][e] = a;
        }
      } else {
        const float* fa = Fs + (diag ? F_QD + i : F_OFF + pair) * FSTR;
        const float* fb = diag ? Fs + (F_KD + i) * FSTR : nullptr;
        const float* qrow = Qh + r0 * LD;
        const float* krow = Kh + s0 * LD;
        mma_3x(acc, ks_k, [&](int r, int c) { return qrow[r * LD + c] * fa[c]; },
               [&](int c, int n) { return krow[n * LD + c] * (fb ? fb[c] : 1.f); }, lane);
        if (diag) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = r0 + g + (e >> 1) * 8, s = s0 + 2 * t4 + (e & 1);
            if (use_u ? s >= t : s > t) acc[0][e] = 0.f;
          }
        }
      }
      float* arow = As + (r0 + g) * LA + s0 + 2 * t4;
      *reinterpret_cast<float2*>(arow) = make_float2(acc[0][0], acc[0][1]);
      *reinterpret_cast<float2*>(arow + 8 * LA) = make_float2(acc[0][2], acc[0][3]);
    }
    __syncthreads();  // (3) the scores are ready; every read of S is done

    // ---- stage C: A v for this warp's output tile, then o and the state
    {
      float av[NH][4];
      zero(av);
      const float* arow = As + rb * 16 * LA;
      mma_3x(av, 2 * (rb + 1), [&](int r, int c) { return arow[r * LA + c]; },
             [&](int c, int n) { return to_f32(Rv[c * L.rv + n0 + n]); }, lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = rb * 16 + g + 8 * hh, pos = t0 + t;
        float dg = 0.f;
        if (use_u)
          for (int cq = 0; cq < kq; ++cq) dg += Dp[cq * CHUNK + t];
        if (pos < T_len) {
          T* orow = o + ((size_t(b) * T_len + pos) * H + h) * V;
#pragma unroll
          for (int i = 0; i < NH; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = n0 + 8 * i + 2 * t4 + e, col = v0 + n;
              float val = oq[i][2 * hh + e] + av[i][2 * hh + e];
              if (use_u) val = fmaf(dg, to_f32(Rv[t * L.rv + n]), val);
              if (col < V) orow[col] = from_f32<T>(val);
            }
        }
      }
    }
    if (owns_state) {
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        float* srow = Ss + (rb * 16 + g) * LS + n0 + 8 * i + 2 * t4;
        *reinterpret_cast<float2*>(srow) = make_float2(S_reg[i][0], S_reg[i][1]);
        *reinterpret_cast<float2*>(srow + 8 * LS) = make_float2(S_reg[i][2], S_reg[i][3]);
      }
    }
    if (tid == 0) *flags = 0;  // read before barrier (3); set again after the next (2)
  }

  if (owns_state) {
#pragma unroll
    for (int i = 0; i < NH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = rb * 16 + g + (e >> 1) * 8, col = v0 + n0 + 8 * i + 2 * t4 + (e & 1);
        if (kr < K && col < V) state[((size_t(b) * H + h) * K + kr) * V + col] = S_reg[i][e];
      }
  }
}

// Copy mode of one input: a copy-engine copy per row where each row's K (or
// V) elements are contiguous, start on a 16-byte boundary and span a
// multiple of 16 bytes, at least 128 (SSD's rows of 64 bytes were faster
// by 16-byte cp.async on the H100, PERF.md); 16-byte cp.async where only
// the last two fail;
// 4-byte copies of single f32 elements at any stride, or of bf16 pairs with
// unit stride on 4-byte boundaries; plain loads otherwise.
int copy_mode(const void* base, const Strides& s, int es, int row) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  auto aligned = [&](int n) {
    return a % n == 0 && (s.b * es) % n == 0 && (s.t * es) % n == 0 && (s.h * es) % n == 0;
  };
  if (s.x == 1 && aligned(16)) return (row * es) % 16 == 0 && row * es >= 128 ? COPY_BULK : COPY_16;
  if (es == 4 || (s.x == 1 && aligned(4))) return COPY_4;
  return COPY_SYNC;
}

template <typename T, typename TL, int NV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ld, const float* u,
                   void* o, float* state, Strides sq, Strides sk, Strides sv, Strides sl, int B,
                   int T_len, int H, int K, int V, const Layout& L, cudaStream_t stream) {
  static SmemOptIn opt_in;  // one per kernel instance
  cudaError_t err = opt_in_smem(opt_in, wkv6_kernel<T, TL, NV>, size_t(L.bytes));
  if (err != cudaSuccess) return err;
  const int4 modes{copy_mode(q, sq, sizeof(T), K), copy_mode(k, sk, sizeof(T), K),
                   copy_mode(v, sv, sizeof(T), V), copy_mode(ld, sl, sizeof(TL), K)};
  dim3 grid((V + 8 * NV - 1) / (8 * NV), H, B);
  wkv6_kernel<T, TL, NV><<<grid, THREADS, L.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TL*>(ld), u, static_cast<T*>(o), state, sq, sk, sv, sl, modes, T_len, H,
      K, V, L);
  return cudaGetLastError();
}

// V slice width: the narrowest of 16, 32, 64 whose blocks all fit on the
// card at once (several per SM where shared memory allows), else the
// widest that fits one block per SM; recomputing the scores in more slices
// costs less than a block left for a second wave.
int choose_vs(int B, int H, int K, int V, int es, int esl) {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int widest = 0;
  for (int vs = 16; vs <= 64; vs *= 2) {
    const int bytes = make_layout(K, vs, es, esl).bytes;
    if (size_t(bytes) > kMaxSmem) break;
    widest = vs;
    const int per_sm = int(kMaxSmem / size_t(bytes + 1024));
    const long blocks = long(B) * H * ((V + vs - 1) / vs);
    if (blocks <= long(sms) * per_sm || vs >= V) return vs;
  }
  return widest;
}

template <typename T, typename TL>
cudaError_t dispatch_vs(const void* q, const void* k, const void* v, const void* ld,
                        const float* u, void* o, float* state, Strides sq, Strides sk,
                        Strides sv, Strides sl, int B, int T_len, int H, int K, int V,
                        cudaStream_t s) {
  const int vs = choose_vs(B, H, K, V, sizeof(T), sizeof(TL));
  if (vs == 0) return cudaErrorInvalidConfiguration;
  const Layout L = make_layout(K, vs, sizeof(T), sizeof(TL));
  if (vs == 16) return launch<T, TL, 2>(q, k, v, ld, u, o, state, sq, sk, sv, sl, B, T_len, H, K, V, L, s);
  if (vs == 32) return launch<T, TL, 4>(q, k, v, ld, u, o, state, sq, sk, sv, sl, B, T_len, H, K, V, L, s);
  return launch<T, TL, 8>(q, k, v, ld, u, o, state, sq, sk, sv, sl, B, T_len, H, K, V, L, s);
}

template <typename T>
cudaError_t dispatch_ld(const void* q, const void* k, const void* v, const void* ld,
                        const float* u, void* o, float* state, Strides sq, Strides sk,
                        Strides sv, Strides sl, int B, int T_len, int H, int K, int V,
                        int ld_dtype, cudaStream_t s) {
  return ld_dtype == 0 ? dispatch_vs<T, float>(q, k, v, ld, u, o, state, sq, sk, sv, sl, B, T_len,
                                               H, K, V, s)
         : ld_dtype == 1 ? dispatch_vs<T, __nv_bfloat16>(q, k, v, ld, u, o, state, sq, sk, sv, sl,
                                                         B, T_len, H, K, V, s)
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
