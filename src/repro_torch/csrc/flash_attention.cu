// Causal / sliding-window GQA flash-attention forward on Hopper's tensor
// cores: kernel K1 and, with an lse output, kernel B2.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py::_attn_kernel
// (K1, the serving path's prefill) and ::_attn_kernel_lse (B2, the training
// forward, which also writes the logsumexp rows the backward kernels of
// flash_attention_bwd.cu read). Both run this one kernel: B2 passes an lse
// pointer, K1 passes null. Same function: online softmax over key tiles,
// -1e30 for masked scores, the row sum l clamped at 1e-30, lse = m +
// log(l), P V with P in f32 (the reference casts v to f32, so its
// p.astype(v.dtype) keeps p in f32), and the output in q's type. With
// causal=0 a nonzero window is one-sided (only qpos - kpos < window), as in
// the TPU kernel and dense_attention.
//
// What bounds it on the H100: at the training shape (S 4096, D 128) each
// (q tile, key tile) pair is two 64 x BK x 128 products, ~S/2 multiply-adds
// per loaded byte, so arithmetic bounds it: on the tensor cores, not the
// f32 FMA units (67 TFLOP/s) that the first version of this kernel used.
// Every product is a warp-level mma.sync (mma.cuh):
//  - f32: 3xTF32, m16n8k8 on each operand split as hi = tf32(x), lo =
//    tf32(x - hi): lo*hi + hi*lo, then hi*hi (495 TFLOP/s a pass, three
//    passes keep f32 accuracy), for Q K^T and for P V.
//  - bf16: m16n8k16 for Q K^T (products of bf16 values are exact in f32).
//    P V keeps P to ~2^-17 relative in two bf16 terms, p_hi = bf16(p) and
//    p_lo = bf16(p - p_hi), as two products on the exact bf16 V: p rounded
//    once to bf16 would move the output by about a unit of bf16 rounding
//    where the reference keeps p in f32 (tests/test_torch_tf32x3.py shows
//    it), and the bf16 output is held to one unit (chip_smoke.py phase 2).
// q enters the score product unscaled and the scale goes on s, folded with
// log2(e) into exp2 (q * scale is not representable in bf16), as in B3/B4.
//
// Accumulation: each key tile's P V sums in a fresh accumulator and is
// folded into the running output with f32 operations, acc = acc * corr +
// tile. The mma's own accumulation is not an IEEE f32 sum; over the
// thousands of keys of a training row it drifts (as B4's dk/dv did,
// PERF.md).
//
// Design: one block per (batch row, q head, 64-row q tile), heaviest
// causal tiles first; 4 warps, each owning 16 q rows across the whole key
// tile (FlashAttention-2's layout), so a row's max and sum reduce over a
// quad with two shuffles and P goes from the score's C fragments to the
// A fragments of P V in registers, never through shared memory (bf16: the
// fragments line up; tf32: logical k t and t+4 read at physical columns 2t
// and 2t+1, with V's B fragment read at rows 2t and 2t+1, mma.cuh). P V
// runs over 64-column slices of D, each in its own fresh 32-register
// accumulator, so the fold costs no second 64-register accumulator. Q
// stays in shared memory and each warp splits (f32) or reads its fragments
// per k step; K and V tiles stream through a two-stage ring filled by
// 16-byte cp.async, so the next tile's copy overlaps the current tile's
// products. Key tiles: 32 rows in f32 (Q 33 KiB + two stages of K and V
// 66 KiB at D=128: two blocks per SM), 64 in bf16 (87 KiB: two blocks per
// SM). The key loop runs from the window bound to the causal bound, so
// fully masked tiles are never loaded (the TPU kernel's pl.when skip), and
// only tiles that straddle the causal, window or Sk edge of a warp's rows
// apply the mask. Unlike the TPU kernel, which raises when the blocks do
// not tile the sequence, any Sq/Sk is taken: keys past Sk are zero-filled
// by the copy and masked, query rows past Sq are not stored. No atomics:
// two runs give the same bits.
//
// Why this layout (H100 80GB HBM3 at 700 W, chip_smoke.py phase 1 and
// PERF.md): at D=128, f32 takes 225 registers and 240 HMMA, bf16 244 and
// 160, neither spills, and both fit two blocks of 4 warps per SM. Each
// warp splits the K and V values it reads into TF32 hi/lo itself; a
// variant that split each tile once per block, shared by 8 warps in
// 8-byte pairs, ran B2 slower (3.35 against 3.25 ms in f32): with the
// integer split of mma.cuh the split no longer sets the time, and the
// extra barrier and the pairs' shared-memory traffic cost more.
//
// Layouts: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), out like q, all
// contiguous and 16-byte aligned (the copies are 16 bytes); q head h reads
// kv head h / (Hq / Hkv). lse (B, Hq, Sq) f32. Registers, spills and the
// HMMA count per instance are read by chip_smoke.py phase 1.

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

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // q rows per block, 16 per warp
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = attn::NEG_INF * kLog2e;  // the reference's -1e30, in log2 units

// Row padding (conflict-free fragment reads, see flash_attention_bwd.cu)
// and key rows per tile.
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int PAD = 4, BK = 32;
};
template <>
struct Tile<bf16> {
  static constexpr int PAD = 8, BK = 64;
};

// Shared memory, in elements of T: the q tile, then a two-stage ring of
// (k, v) tiles, all rows of D + PAD.
template <typename T, int D>
struct Layout {
  static constexpr int BK = Tile<T>::BK;
  static constexpr int LD = D + Tile<T>::PAD;
  static constexpr size_t q = size_t(BQ) * LD;
  static constexpr size_t stage = 2 * size_t(BK) * LD;
  static constexpr size_t bytes = (q + 2 * stage) * sizeof(T);
};

// acc (16 x D) = acc * corr + P V for the warp's rows: p the warp's scores
// after the softmax (NT 8-column C fragments over the key tile), V a BK-row
// tile of stride LD. Slices of CH 8-column tiles of D sum in a fresh
// accumulator each, folded with f32 fmas (corr[0] for row g, corr[1] for
// row g + 8). A slice's CH accumulators are its independent mma chains:
// up to 8 (64 columns, 32 registers), the largest such divisor of the tile
// count; with 32-column slices B2 took 9% (f32) and 18% (bf16) longer on
// an H100 (PERF.md).
__host__ __device__ constexpr int slice_tiles(int nd) {
  return nd <= 8 ? nd : nd % 8 == 0 ? 8 : nd / 2;
}

template <int N, int CH>
__device__ __forceinline__ void fold(float (&acc)[N][4], int c, const float (&part)[CH][4],
                                     const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c + i][e] = fmaf(acc[c + i][e], corr[e >> 1], part[i][e]);
}

template <int D, int LD, int NT>
__device__ __forceinline__ void pv(float (&acc)[D / 8][4], const float (&p)[NT][4],
                                   const float (&corr)[2], const float* V, int lane) {
  constexpr int ND = D / 8, CH = slice_tiles(ND);
  const int g = lane >> 2, t = lane & 3;
  // k step j is score tile j; logical k t, t + 4 at its columns 2t, 2t + 1
  uint32_t ahi[NT][4], alo[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float av[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
    mma::split4(ahi[j], alo[j], av);
  }
#pragma unroll
  for (int c = 0; c < ND; c += CH) {
    float part[CH][4] = {};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* b = V + (8 * j + 2 * t) * LD + 8 * c + g;
      mma::Tf32Pair b0[CH], b1[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        b0[i] = mma::split_tf32(b[8 * i]);
        b1[i] = mma::split_tf32(b[LD + 8 * i]);
      }
      mma::mma_3xtf32(part, part, ahi[j], alo[j], b0, b1);
    }
    fold(acc, c, part, corr);
  }
}

// bf16 pair (x0, x1) as hi = bf16(x) and lo = bf16(x - hi), packed.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = mma::pack_bf16(x0 - hf.x, x1 - hf.y);
}

template <int D, int LD, int NT>
__device__ __forceinline__ void pv(float (&acc)[D / 8][4], const float (&p)[NT][4],
                                   const float (&corr)[2], const bf16* V, int lane) {
  constexpr int ND = D / 8, CH = slice_tiles(ND);
  // k step j (16 keys) is score tiles 2j and 2j + 1
  uint32_t ahi[NT / 2][4], alo[NT / 2][4];
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    split_bf16(p[2 * j][0], p[2 * j][1], ahi[j][0], alo[j][0]);
    split_bf16(p[2 * j][2], p[2 * j][3], ahi[j][1], alo[j][1]);
    split_bf16(p[2 * j + 1][0], p[2 * j + 1][1], ahi[j][2], alo[j][2]);
    split_bf16(p[2 * j + 1][2], p[2 * j + 1][3], ahi[j][3], alo[j][3]);
  }
#pragma unroll
  for (int c = 0; c < ND; c += CH) {
    float part[CH][4] = {};
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      const bf16* row = V + (16 * j + (lane & 15)) * LD + 8 * c;  // ldmatrix row addresses
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        uint32_t b0, b1;
        mma::ldmatrix_x2_trans(b0, b1, row + 8 * i);
        mma::mma_bf16(part[i], alo[j], b0, b1);
        mma::mma_bf16(part[i], ahi[j], b0, b1);
      }
    }
    fold(acc, c, part, corr);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                int causal, int window, float scale) {
  using L = Layout<T, D>;
  constexpr int BK = L::BK, LD = L::LD;
  constexpr int NT = BK / 8;  // 8-column tiles of a warp's scores
  constexpr int ND = D / 8;   // 8-column tiles of a warp's output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // BQ x LD
  T* ring = Qs + L::q;                     // stage s: k at ring + s * stage, v after it

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int r0 = q0 + warp * 16;  // the warp's first row

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int steps = k_end > k_begin ? (k_end + BK - 1) / BK - t_begin : 0;

  const T* kh = k + (size_t(b) * Sk * Hkv + hk) * D;
  const T* vh = v + (size_t(b) * Sk * Hkv + hk) * D;
  auto issue = [&](int step) {
    T* st = ring + (step & 1) * L::stage;
    const int k0 = (t_begin + step) * BK;
    mma::load_rows<T, D, LD, BK, THREADS>(st, kh, k0, Sk, Hkv, tid);
    mma::load_rows<T, D, LD, BK, THREADS>(st + BK * LD, vh, k0, Sk, Hkv, tid);
    mma::cp_async_commit();
  };
  if (steps > 0) {
    mma::load_rows<T, D, LD, BQ, THREADS>(Qs, q + (size_t(b) * Sq * Hq + h) * D, q0, Sq, Hq,
                                          tid);
    issue(0);  // one group with the q tile
  }

  // rows g and g + 8 of the warp's 16: running max (log2 units) and this
  // thread's share of the row sum (its columns; the quad's shares are
  // added at the end)
  float m2[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[ND][4] = {};
  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  for (int step = 0; step < steps; ++step) {
    mma::cp_async_wait<0>();
    __syncthreads();  // this step's tiles are in; the last step's reads are done
    if (step + 1 < steps) issue(step + 1);
    const int k0 = (t_begin + step) * BK;
    const T* Kt = ring + (step & 1) * L::stage;
    const T* Vt = Kt + BK * LD;

    float s[NT][4];
    mma::warp_abt<D, LD, NT>(s, Qs + warp * 16 * LD, Kt, lane);
    auto scale_mask = [&](auto whole) {  // scaled scores in log2 units
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = r0 + g + 8 * (e >> 1);
          const int kp = k0 + 8 * i + 2 * t + (e & 1);
          s[i][e] = (decltype(whole)::value || visible(qp, kp, Sk, causal, window))
                        ? s[i][e] * scale2
                        : kMasked;
        }
    };
    // a key tile that every row of the warp sees skips the mask
    if (k0 + BK <= Sk && (!causal || k0 + BK - 1 <= r0) &&
        (window <= 0 || r0 + 15 - k0 < window))
      scale_mask(std::true_type{});
    else
      scale_mask(std::false_type{});

    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m2[r];
#pragma unroll
      for (int i = 0; i < NT; ++i) mx = fmaxf(mx, fmaxf(s[i][2 * r], s[i][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = exp2f(m2[r] - mx);
      m2[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(s[i][2 * r + c] - mx);
          s[i][2 * r + c] = p;
          sum += p;
        }
      l[r] = fmaf(l[r], corr[r], sum);
    }
    pv<D, LD, NT>(acc, s, corr, Vt, lane);
  }

  T* oh = o + (size_t(b) * Sq * Hq + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qp = r0 + g + 8 * r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(sum, 1e-30f);
    if (lse != nullptr && t == 0)
      lse[(size_t(b) * Hq + h) * Sq + qp] = fmaf(m2[r], kLn2, logf(denom));
    const float inv = __fdividef(1.f, denom);  // inline: no division subroutine
    T* row = oh + size_t(qp) * Hq * D + 2 * t;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      mma::store_pair(row + 8 * i, acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Sk, int Hq, int Hkv, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D>::bytes;
  static_assert(smem <= kMaxSmem, "the forward's tiles exceed the shared memory of a block");
  static SmemOptIn opt_in;  // one per kernel instance
  cudaError_t err = opt_in_smem(opt_in, attn_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  attn_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Sk, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Sq, int Sk, int Hq, int Hkv, int D, int causal, int window,
                       float scale, cudaStream_t stream) {
#define REPRO_FWD_CASE(DIM) \
  case DIM:                 \
    return launch<T, DIM>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, window, scale, stream);
  switch (D) {  // HEAD_DIMS of kernels/flash_attention.py
    REPRO_FWD_CASE(16)
    REPRO_FWD_CASE(32)
    REPRO_FWD_CASE(64)
    REPRO_FWD_CASE(128)
    REPRO_FWD_CASE(160)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FWD_CASE
}

cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
                int Sk, int Hq, int Hkv, int D, int causal, int window, float scale, int dtype,
                void* stream) {
  if (Sq <= 0 || B <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  // 16-byte copies of q, k, v; paired stores of o
  if (!aligned(q, 16) || !aligned(k, 16) || !aligned(v, 16) || !aligned(o, 8) ||
      !aligned(lse, 4))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0   ? dispatch_d<float>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, D, causal,
                                          window, scale, s)
         : dtype == 1 ? dispatch_d<bf16>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, D, causal,
                                         window, scale, s)
                      : cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaGetLastError()
// (cudaErrorMisalignedAddress for q, k or v not on a 16-byte boundary).
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
