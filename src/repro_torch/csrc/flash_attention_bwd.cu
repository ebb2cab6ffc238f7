// Causal / sliding-window GQA flash-attention backward on Hopper's tensor
// cores: kernels B3 (dq) and B4 (dk, dv).
//
// Replace the TPU kernels src/repro/kernels/flash_attention.py::_dq_kernel
// and ::_dkv_kernel (entry point flash_attention_bwd). Same function: p =
// exp(s - lse) with s = (q k^T) * 1/sqrt(D) where the mask allows and
// exactly 0 where it does not, ds = p * (dp - delta) with dp = dO V^T, and
//   dq = ds K * scale,  dk = ds^T q * scale,  dv = p^T dO,
// dk and dv summed over each GQA group. lse (B, Hq, Sq) f32 comes from the
// forward (kernel B2, flash_attention.cu) and delta (B, Hq, Sq) f32 =
// rowsum(dO * O) from a plain reduction in the wrapper, as the TPU wrapper
// computes it outside its kernels. The scale is applied to s, dq and dk
// rather than to q: in bf16, q * scale is not representable.
//
// What bounds them on the H100: at the training shape (S 4096, D 128) each
// (q tile, key tile) pair is 3 (dq) or 4 (dk, dv) 64x64x128 products, ~S/2
// multiply-adds per loaded byte, so arithmetic bounds them: on the tensor
// cores, not the FMA units (67 TFLOP/s f32), which the first versions of
// these kernels used. Every product here is a warp-level mma.sync
// (mma.cuh):
//  - bf16: m16n8k16, f32 accumulators (989 TFLOP/s dense). P and dS enter
//    the second products rounded to bf16, as FlashAttention-2 does; the
//    reference keeps them in f32 (a deliberate difference, ROADMAP C).
//  - f32: 3xTF32, m16n8k8 on each operand split as hi = tf32(x), lo =
//    tf32(x - hi): lo*hi + hi*lo, then hi*hi; three passes at 495 TFLOP/s
//    keep f32 accuracy (single TF32 keeps ~3 digits, too few for the
//    training gates).
// wgmma (the full tensor-core rate) is later work: for tf32 it needs
// K-major shared-memory operands, and B4's ds^T q and p^T dO and B3's ds K
// are transposed products.
//
// Design, both kernels: 256 threads, 8 warps; a block keeps 64 resident
// rows (B3: its q and dO tile; B4: its k and v tile) in shared memory and
// streams tiles of the other operand (B3: k, v; B4: q, dO, lse and delta
// rows) through a two-stage ring filled by 16-byte cp.async, so the next
// tile's copy overlaps the current tile's products; rows past the end are
// zero-filled by the copy and masked. Warps pair up on 16 resident rows:
// for the scores, each warp of the pair takes half of the streamed columns
// and writes its p / ds block to shared memory; after a barrier, each warp
// of the pair accumulates half of the head dim's columns (dq, or dk and dv)
// from the pair's whole p / ds rows, so the accumulators take 32 (B3) or
// 64 (B4) registers a thread at D=128.
//
// Shared memory and bank conflicts: rows are padded to D+4 floats or D+8
// halves, so fragment reads are conflict-free: in f32 with 32-bit loads
// (the transposed operand read at rows 2t and 2t+1, see mma.cuh), in bf16
// with 32-bit loads and ldmatrix.trans for the transposed operand. One f32
// 64x128 tile is 33 KiB, so f32 B4 (and f32 B3 at D=160) streams 32-row
// tiles to fit both ring stages next to its resident tiles (at D=128, f32
// B4 takes 152.5 KiB, f32 B3 216 KiB); the others stream 64 rows. One
// block per SM, except bf16 B3 (111 KiB, 126 registers at D=128: two). Whole tiles, which
// every (query, key) pair of the block sees, skip the mask.
//
// B3: one block per (batch row, q head, 64-row q tile), heaviest causal
// tiles first; the key tiles run from the window bound to the causal bound
// (fully masked tiles are never loaded, the TPU kernel's pl.when skip).
// B4: one block per (batch row, kv head, 64-row key tile). It walks its GQA
// group's q heads and, for each, the q tiles that can see its keys, as one
// sequence of ring steps, with dk and dv in registers throughout: the
// group sum of the TPU wrapper (:334-335) happens in a fixed order, with
// no atomics and no partials in device memory, so two runs give the same
// bits. B3 uses no atomics either.
//
// Both take any Sq/Sk (the TPU backward silently drops tail rows when its
// blocks do not tile the sequence). Layouts: q, dO (B, Sq, Hq, D); k, v
// (B, Sk, Hkv, D); dq like q; dk, dv like k; all contiguous, 16-byte
// aligned (the copies are 16 bytes). q head h reads kv head h / (Hq /
// Hkv). Both need more than 48 KB of shared memory (smem_opt_in.cuh).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tile.cuh"
#include "mma.cuh"
#include "smem_opt_in.cuh"

namespace {

using attn::aligned;
using attn::kLog2e;
using attn::visible;
using bf16 = __nv_bfloat16;
using mma::add_into;
using mma::split4;
using mma::store_pair;
using mma::warp_abt;

constexpr int THREADS = 256;  // 8 warps: 4 groups of 16 resident rows x 2 halves
constexpr int ROWS = 64;      // resident rows per block

// Row padding, and the rows of B3's (NS_DQ) and B4's (NS_DKV) streamed
// tiles: 64, or 32 where two ring stages of 64 would not fit beside the
// resident tiles (f32 B3 at D=160, f32 B4).
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int PAD = 4;   // row stride D + 4 floats
  template <int D>
  static constexpr int NS_DQ = D > 128 ? 32 : 64;
  static constexpr int NS_DKV = 32;
};
template <>
struct Tile<bf16> {
  static constexpr int PAD = 8;   // row stride D + 8 halves
  template <int D>
  static constexpr int NS_DQ = 64;
  static constexpr int NS_DKV = 64;
};

// Shared-memory layout, in elements of T: tiles of rows of D + PAD, and the
// p / ds tiles ROWS x (NS + 8).
template <typename T, int D, int NS_>
struct Layout {
  static constexpr int NS = NS_;
  static constexpr int LD = D + Tile<T>::PAD;
  static constexpr int LDP = NS + 8;
  static constexpr size_t resident = size_t(ROWS) * LD;
  static constexpr size_t stage = 2 * size_t(NS) * LD;  // two streamed tiles
  static constexpr size_t pds = size_t(ROWS) * LDP;
  // B3: q, dO; ring of (k, v); ds
  static constexpr size_t dq_bytes = (2 * resident + 2 * stage + pds) * sizeof(T);
  // B4: k, v; ring of (q, dO); p^T, ds^T; ring of (lse, delta) rows
  static constexpr size_t dkv_bytes =
      (2 * resident + 2 * stage + 2 * pds) * sizeof(T) + 2 * 2 * NS * sizeof(float);
};

// -------------------------------------------------------- warp products
// (mma.cuh: a warp's 16 rows are g = lane / 4 and g + 8; its C fragment
// for 8-column tile i holds columns 8i + 2t and 8i + 2t + 1, t = lane % 4)

// acc (16 x 8ND) += P B over NS: P the warp's 16 rows of a p / ds tile
// (stride LDP), B an NS-row tile (stride LD) from its first column. The
// step's product is summed on the tensor cores in a fresh accumulator and
// added to acc with f32 adds: the mma's accumulation is not an IEEE f32
// sum, and over the thousands of steps of B4's group sum it drifted by
// 1.2e-4 (relative) from the plain f32 result on an H100, against 3e-6
// for B3's shorter sums. The tf32 version reads logical k t and t + 4 at
// physical 2t and 2t + 1.
template <int NS, int LDP, int LD, int ND>
__device__ __forceinline__ void warp_ab(float (&acc)[ND][4], const float* P, const float* B,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  float part[ND][4] = {};
#pragma unroll
  for (int k = 0; k < NS; k += 8) {
    const float2 x0 = *reinterpret_cast<const float2*>(P + g * LDP + k + 2 * t);
    const float2 x1 = *reinterpret_cast<const float2*>(P + (g + 8) * LDP + k + 2 * t);
    const float av[4] = {x0.x, x1.x, x0.y, x1.y};
    uint32_t ahi[4], alo[4];
    split4(ahi, alo, av);
    const float* b = B + (k + 2 * t) * LD + g;
    mma::Tf32Pair b0[ND], b1[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      b0[i] = mma::split_tf32(b[8 * i]);
      b1[i] = mma::split_tf32(b[LD + 8 * i]);
    }
    mma::mma_3xtf32(part, part, ahi, alo, b0, b1);
  }
  add_into(acc, part);
}

template <int NS, int LDP, int LD, int ND>
__device__ __forceinline__ void warp_ab(float (&acc)[ND][4], const bf16* P, const bf16* B,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  float part[ND][4] = {};
#pragma unroll
  for (int k = 0; k < NS; k += 16) {
    const bf16* a = P + g * LDP + k + 2 * t;
    const uint32_t af[4] = {mma::ld_u32(a), mma::ld_u32(a + 8 * LDP), mma::ld_u32(a + 8),
                            mma::ld_u32(a + 8 * LDP + 8)};
    const bf16* row = B + (k + (lane & 15)) * LD;  // ldmatrix row addresses
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      uint32_t b0, b1;
      mma::ldmatrix_x2_trans(b0, b1, row + 8 * i);
      mma::mma_bf16(part[i], af, b0, b1);
    }
  }
  add_into(acc, part);
}

// Writes a warp's C fragments (16 x 8NT) into rows of stride LDP.
template <int LDP, int NT, typename T>
__device__ __forceinline__ void store_tile(T* P, const float (&c)[NT][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    store_pair(P + g * LDP + 8 * i + 2 * t, c[i][0], c[i][1]);
    store_pair(P + (g + 8) * LDP + 8 * i + 2 * t, c[i][2], c[i][3]);
  }
}

// Writes a warp's accumulators (16 rows from row r0, 8ND columns from col0)
// times f into rows of a (B, S, H, D) head (dst at its row 0).
template <int D, int ND, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&c)[ND][4], float f, int r0,
                                           int col0, int S, int H, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= S) continue;
    T* row = dst + size_t(r) * H * D + col0 + 2 * t;
#pragma unroll
    for (int i = 0; i < ND; ++i) store_pair(row + 8 * i, c[i][2 * half] * f, c[i][2 * half + 1] * f);
  }
}

// ---------------------------------------------------------------- kernels

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int Hq,
               int Hkv, int causal, int window, float scale) {
  using L = Layout<T, D, Tile<T>::template NS_DQ<D>>;
  constexpr int NS = L::NS, LD = L::LD, LDP = L::LDP;
  constexpr int NT = NS / 16;  // 8-column tiles of a warp's half of the scores
  constexpr int ND = D / 16;   // 8-column tiles of a warp's half of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // ROWS x LD
  T* dOs = Qs + L::resident;               // ROWS x LD
  T* ring = dOs + L::resident;             // stage s: k at ring + s * stage, v after it
  T* dSs = ring + 2 * L::stage;            // ROWS x LDP

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp >> 1, half = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * ROWS;

  const int k_end = causal ? min(Sk, q0 + ROWS) : Sk;
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / NS;
  const int steps = k_end > k_begin ? (k_end + NS - 1) / NS - t_begin : 0;

  const T* kh = k + (size_t(b) * Sk * Hkv + hk) * D;
  const T* vh = v + (size_t(b) * Sk * Hkv + hk) * D;
  auto issue = [&](int step) {
    T* st = ring + (step & 1) * L::stage;
    const int k0 = (t_begin + step) * NS;
    mma::load_rows<T, D, LD, NS, THREADS>(st, kh, k0, Sk, Hkv, tid);
    mma::load_rows<T, D, LD, NS, THREADS>(st + NS * LD, vh, k0, Sk, Hkv, tid);
    mma::cp_async_commit();
  };
  if (steps > 0) {
    mma::load_rows<T, D, LD, ROWS, THREADS>(Qs, q + (size_t(b) * Sq * Hq + h) * D, q0, Sq, Hq,
                                            tid);
    mma::load_rows<T, D, LD, ROWS, THREADS>(dOs, dout + (size_t(b) * Sq * Hq + h) * D, q0, Sq,
                                            Hq, tid);
    issue(0);  // one group with the resident tiles
  }

  // rows g and g + 8 of the warp's 16: lse in log2 units, delta
  float lse2[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + rg * 16 + g + 8 * i;
    const size_t row = (size_t(b) * Hq + h) * Sq + qp;
    lse2[i] = qp < Sq ? lse[row] * kLog2e : 0.f;
    delta_r[i] = qp < Sq ? delta[row] : 0.f;
  }
  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))

  float acc[ND][4] = {};
  for (int step = 0; step < steps; ++step) {
    mma::cp_async_wait<0>();
    __syncthreads();  // this step's tiles are in; the last step's reads are done
    if (step + 1 < steps) issue(step + 1);
    const int k0 = (t_begin + step) * NS;
    const T* Kt = ring + (step & 1) * L::stage;
    const T* Vt = Kt + NS * LD;

    float s[NT][4], dp[NT][4];
    warp_abt<D, LD, NT>(s, Qs + rg * 16 * LD, Kt + half * (NS / 2) * LD, lane);
    warp_abt<D, LD, NT>(dp, dOs + rg * 16 * LD, Vt + half * (NS / 2) * LD, lane);
    auto grad_scores = [&](auto whole) {  // ds = p (dp - delta), in dp
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = q0 + rg * 16 + g + 8 * (e >> 1);
          const int kp = k0 + half * (NS / 2) + 8 * i + 2 * t + (e & 1);
          const float p = (decltype(whole)::value || visible(qp, kp, Sk, causal, window))
                              ? exp2f(fmaf(s[i][e], scale2, -lse2[e >> 1]))
                              : 0.f;
          dp[i][e] = p * (dp[i][e] - delta_r[e >> 1]);
        }
    };
    // a key tile that every row of the block sees skips the mask
    if (k0 + NS <= Sk && (!causal || k0 + NS - 1 <= q0) &&
        (window <= 0 || q0 + ROWS - 1 - k0 < window))
      grad_scores(std::true_type{});
    else
      grad_scores(std::false_type{});
    store_tile<LDP>(dSs + rg * 16 * LDP + half * (NS / 2), dp, lane);
    __syncthreads();
    warp_ab<NS, LDP, LD>(acc, dSs + rg * 16 * LDP, Kt + half * (D / 2), lane);
  }

  store_rows<D>(dq + (size_t(b) * Sq * Hq + h) * D, acc, scale, q0 + rg * 16, half * (D / 2), Sq,
                Hq, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq,
                int Sk, int Hq, int Hkv, int causal, int window, float scale) {
  using L = Layout<T, D, Tile<T>::NS_DKV>;
  constexpr int NS = L::NS, LD = L::LD, LDP = L::LDP;
  constexpr int NT = NS / 16;  // 8-column tiles of a warp's half of the scores
  constexpr int ND = D / 16;   // 8-column tiles of a warp's half of dk, dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // ROWS x LD
  T* Vs = Ks + L::resident;                // ROWS x LD
  T* ring = Vs + L::resident;              // stage s: q at ring + s * stage, dO after it
  T* Ps = ring + 2 * L::stage;             // p^T, ROWS x LDP
  T* dSs = Ps + L::pds;                    // ds^T, ROWS x LDP
  float* rows = reinterpret_cast<float*>(dSs + L::pds);  // stage s: lse at rows + 2 NS s, delta after

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp >> 1, half = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.x;  // causal: low key tiles see the most queries, run first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int k0 = kt * ROWS;

  // queries that can see keys k0 .. k0+ROWS-1: from k0 if causal, and below
  // k0 + ROWS - 1 + window for a causal window
  const int q_begin = causal ? k0 : 0;
  const int q_end = (causal && window > 0) ? min(Sq, k0 + ROWS - 1 + window) : Sq;
  const int t_begin = q_begin / NS;
  const int per_head = q_end > q_begin ? (q_end + NS - 1) / NS - t_begin : 0;
  const int steps = group * per_head;  // (q head, q tile) pairs, head-major

  auto issue = [&](int step) {
    const int h = hk * group + step / per_head;
    const int q0 = (t_begin + step % per_head) * NS;
    T* st = ring + (step & 1) * L::stage;
    mma::load_rows<T, D, LD, NS, THREADS>(st, q + (size_t(b) * Sq * Hq + h) * D, q0, Sq, Hq,
                                          tid);
    mma::load_rows<T, D, LD, NS, THREADS>(st + NS * LD, dout + (size_t(b) * Sq * Hq + h) * D, q0,
                                          Sq, Hq, tid);
    if (tid < 2 * NS) {
      const float* src = tid < NS ? lse : delta;
      const int qp = q0 + tid % NS;
      const bool ok = qp < Sq;
      mma::cp_async4(rows + (step & 1) * 2 * NS + tid,
                     ok ? src + (size_t(b) * Hq + h) * Sq + qp : src, ok);
    }
    mma::cp_async_commit();
  };
  if (steps > 0) {
    mma::load_rows<T, D, LD, ROWS, THREADS>(Ks, k + (size_t(b) * Sk * Hkv + hk) * D, k0, Sk, Hkv,
                                            tid);
    mma::load_rows<T, D, LD, ROWS, THREADS>(Vs, v + (size_t(b) * Sk * Hkv + hk) * D, k0, Sk, Hkv,
                                            tid);
    issue(0);  // one group with the resident tiles
  }

  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  float dk_acc[ND][4] = {}, dv_acc[ND][4] = {};
  for (int step = 0; step < steps; ++step) {
    mma::cp_async_wait<0>();
    __syncthreads();  // this step's tiles are in; the last step's reads are done
    if (step + 1 < steps) issue(step + 1);
    const int q0 = (t_begin + step % per_head) * NS;
    const T* Qt = ring + (step & 1) * L::stage;
    const T* dOt = Qt + NS * LD;
    const float* lse_s = rows + (step & 1) * 2 * NS;
    const float* delta_s = lse_s + NS;

    // transposed scores: the warp's 16 keys x its half of the NS queries
    float s[NT][4], dp[NT][4];
    warp_abt<D, LD, NT>(s, Ks + rg * 16 * LD, Qt + half * (NS / 2) * LD, lane);
    warp_abt<D, LD, NT>(dp, Vs + rg * 16 * LD, dOt + half * (NS / 2) * LD, lane);
    auto grad_scores = [&](auto whole) {  // p in s, ds = p (dp - delta) in dp
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + rg * 16 + g + 8 * (e >> 1);
          const int c = half * (NS / 2) + 8 * i + 2 * t + (e & 1);
          const int qp = q0 + c;
          const float p =
              (decltype(whole)::value || (qp < Sq && visible(qp, kp, Sk, causal, window)))
                  ? exp2f(fmaf(s[i][e], scale2, -lse_s[c] * kLog2e))
                  : 0.f;
          s[i][e] = p;
          dp[i][e] = p * (dp[i][e] - delta_s[c]);
        }
    };
    // a q tile that sees every key of the block skips the mask
    if (q0 + NS <= Sq && k0 + ROWS <= Sk && (!causal || q0 >= k0 + ROWS - 1) &&
        (window <= 0 || q0 + NS - 1 - k0 < window))
      grad_scores(std::true_type{});
    else
      grad_scores(std::false_type{});
    store_tile<LDP>(Ps + rg * 16 * LDP + half * (NS / 2), s, lane);
    store_tile<LDP>(dSs + rg * 16 * LDP + half * (NS / 2), dp, lane);
    __syncthreads();
    warp_ab<NS, LDP, LD>(dv_acc, Ps + rg * 16 * LDP, dOt + half * (D / 2), lane);
    warp_ab<NS, LDP, LD>(dk_acc, dSs + rg * 16 * LDP, Qt + half * (D / 2), lane);
  }

  const size_t head = (size_t(b) * Sk * Hkv + hk) * D;
  store_rows<D>(dk + head, dk_acc, scale, k0 + rg * 16, half * (D / 2), Sk, Hkv, lane);
  store_rows<D>(dv + head, dv_acc, 1.f, k0 + rg * 16, half * (D / 2), Sk, Hkv, lane);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, Hq, Hkv, causal, window;
  float scale;
  cudaStream_t stream;
};

// B3: a block per (ROWS q rows, q head, row); B4: per (ROWS key rows, kv
// head, row).
dim3 dq_grid(int B, int Sq, int Hq) { return dim3((Sq + ROWS - 1) / ROWS, Hq, B); }
dim3 dkv_grid(int B, int Sk, int Hkv) { return dim3((Sk + ROWS - 1) / ROWS, Hkv, B); }

template <typename T, int D>
constexpr size_t dq_smem() {
  return Layout<T, D, Tile<T>::template NS_DQ<D>>::dq_bytes;
}
template <typename T, int D>
constexpr size_t dkv_smem() {
  return Layout<T, D, Tile<T>::NS_DKV>::dkv_bytes;
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem<T, D>();
  static_assert(smem <= kMaxSmem, "B3's tiles exceed the shared memory of a block");
  static SmemOptIn opt_in;  // one per kernel instance
  cudaError_t err = opt_in_smem(opt_in, attn_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  attn_dq_kernel<T, D><<<dq_grid(a.B, a.Sq, a.Hq), THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), a.Sq, a.Sk, a.Hq,
      a.Hkv, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem<T, D>();
  static_assert(smem <= kMaxSmem, "B4's tiles exceed the shared memory of a block");
  static SmemOptIn opt_in;  // one per kernel instance
  cudaError_t err = opt_in_smem(opt_in, attn_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  attn_dkv_kernel<T, D><<<dkv_grid(a.B, a.Sk, a.Hkv), THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.Sq, a.Sk, a.Hq, a.Hkv, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int D, bool dkv) {
#define REPRO_BWD_CASE(DIM) \
  case DIM: return dkv ? launch_dkv<T, DIM>(a) : launch_dq<T, DIM>(a);
  switch (D) {  // the head dims of K1 (flash_attention.cu)
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(128)
    REPRO_BWD_CASE(160)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_CASE
}

// The launch of B3 (dkv false) or B4 for these sizes: grid, threads,
// shared bytes.
template <typename T>
int bwd_plan(int B, int Sq, int Sk, int Hq, int Hkv, int D, bool dkv, int64_t* out) {
  size_t smem = 0;
#define REPRO_BWD_PLAN(DIM) \
  case DIM: smem = dkv ? dkv_smem<T, DIM>() : dq_smem<T, DIM>(); break;
  switch (D) {
    REPRO_BWD_PLAN(16)
    REPRO_BWD_PLAN(32)
    REPRO_BWD_PLAN(64)
    REPRO_BWD_PLAN(128)
    REPRO_BWD_PLAN(160)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_PLAN
  const dim3 g = dkv ? dkv_grid(B, Sk, Hkv) : dq_grid(B, Sq, Hq);
  const int64_t v[6] = {g.x, g.y, g.z, THREADS, int64_t(smem), 1};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return cudaSuccess;
}

int plan(int B, int Sq, int Sk, int Hq, int Hkv, int D, int dtype, bool dkv, int64_t* out) {
  if (B <= 0 || (dkv ? Sk : Sq) <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  return dtype == 0   ? bwd_plan<float>(B, Sq, Sk, Hq, Hkv, D, dkv, out)
         : dtype == 1 ? bwd_plan<bf16>(B, Sq, Sk, Hq, Hkv, D, dkv, out)
                      : cudaErrorInvalidValue;
}

int run(const Args& a, int D, int dtype, bool dkv) {
  if (a.B <= 0 || (dkv ? a.Sk : a.Sq) <= 0) return cudaSuccess;
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0) return cudaErrorInvalidValue;
  // 16-byte copies of q, k, v, dO; paired stores of dq, dk, dv
  if (!aligned(a.q, 16) || !aligned(a.k, 16) || !aligned(a.v, 16) || !aligned(a.dout, 16) ||
      !aligned(a.lse, 4) || !aligned(a.delta, 4) || !aligned(dkv ? a.dk : a.dq, 8) ||
      (dkv && !aligned(a.dv, 8)))
    return cudaErrorMisalignedAddress;
  cudaError_t err = dtype == 0   ? dispatch<float>(a, D, dkv)
                    : dtype == 1 ? dispatch<bf16>(a, D, dkv)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; lse and delta (B, Hq, Sq) f32. Each
// returns the launch's cudaGetLastError() (cudaErrorMisalignedAddress for
// a tensor that does not start on a 16-byte boundary).

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

// The launches repro_flash_attention_dq and repro_flash_attention_dkv make
// for these sizes, by the same grids and Layouts: out = grid x, y, z,
// threads, dynamic shared bytes, cluster x. Launch nothing.
extern "C" int repro_flash_attention_dq_plan(int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                             int dtype, int64_t* out) {
  return plan(B, Sq, Sk, Hq, Hkv, D, dtype, false, out);
}

extern "C" int repro_flash_attention_dkv_plan(int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                              int dtype, int64_t* out) {
  return plan(B, Sq, Sk, Hq, Hkv, D, dtype, true, out);
}
