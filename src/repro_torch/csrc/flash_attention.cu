// Causal / sliding-window GQA flash-attention forward on Hopper's tensor
// cores: kernel K1 and, with an lse output, kernel B2.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py:40
// _attn_kernel (K1, the serving path's prefill) and :97 _attn_kernel_lse
// (B2, the training forward, which also writes the logsumexp rows the
// backward kernels of flash_attention_bwd.cu read). Both run one kernel: B2
// passes an lse pointer, K1 passes null. Same function: online softmax over
// key tiles, -1e30 for masked scores, the row sum l clamped at 1e-30, lse =
// m + log(l) in f32 as (B, Hq, Sq), P V with P in f32 (the reference casts v
// to f32, so its p.astype(v.dtype) keeps p in f32), and the output in q's
// type. With causal=0 a nonzero window is one-sided (only qpos - kpos <
// window), as in the TPU kernel and dense_attention. Any Sq and Sk (Sq != Sk
// too: whisper's cross attention); q head h reads kv head h / (Hq / Hkv).
//
// What bounds it on the H100: at the shapes the card runs (S 128 to 4096, D
// 64 and 128) each (q tile, key tile) pair is two 64 x BK x D products,
// ~S/2 multiply-adds per loaded byte, so tensor-core operations bound it.
// q enters the score product unscaled and the scale goes on s, folded with
// log2(e) into exp2 (q * scale is not representable in bf16), as in B3/B4.
// P V keeps P to ~2^-17 relative: in bf16 as two bf16 terms, p_hi = bf16(p)
// and p_lo = bf16(p - p_hi), two products on the exact bf16 V (p rounded
// once to bf16 moves the output by about a unit of bf16 rounding where the
// reference keeps p in f32, tests/test_torch_tf32x3.py shows it, and the
// bf16 output is held to one unit, chip_smoke.py phase 2); in f32 by
// 3xTF32. Each key tile's P V sums in a fresh accumulator and is folded into
// the running output with f32 operations, acc = acc * corr + tile: the
// tensor cores' own accumulation is not an IEEE f32 sum, and over the
// thousands of keys of a training row it drifts (as B4's dk/dv did,
// PERF.md). No atomics: two runs give the same bits.
//
// Which kernel runs is a fixed rule on (dtype, D), in fwd() and fwd_plan():
//  - bf16 at D 64 and 128 (granite, qwen2.5, qwen2-vl, arctic and llama4
//    at D128, whisper and hymba at D64): attn_fwd_kernel_wgmma, Hopper's
//    warpgroup products fed by TMA;
//  - f32 at any D, and bf16 at D 16, 32 and 160 (stablelm-12b, the one
//    configuration at D160, serves in bf16 through these, chip_smoke.py
//    phase 11e): attn_fwd_kernel, warp-level mma.sync. TF32 wgmma needs
//    both operands K-major, so P V would need V transposed, and 3xTF32
//    three passes of it: the f32 path stays on mma.sync.
// A launch error raises in the wrapper; nothing falls back to another
// kernel.
//
// attn_fwd_kernel_wgmma (bf16, D 64/128): a block per (batch row, q head,
// BQ-row q tile), heaviest causal tiles first; NC consumer warpgroups of 64
// q rows each (BQ = 64 NC), then a producer. One producer thread loads the
// q tile once and streams the K and V tiles through a ring by TMA
// (cp.async.bulk.tensor from 4-D tensor maps over (D, H, S, B), encoded on
// the host per call, boxes of 64 columns, 128-byte swizzle; keys past Sk
// are zero-filled by the hardware and never read the next batch row), each
// stage with a full mbarrier for K, one for V and an empty one that every
// consumer warp releases. Each consumer warpgroup: S = Q K^T by wgmma
// m64nBKk16 with both operands from the swizzled tiles; the online softmax
// on the accumulator fragments (a row's max and sum reduce over a quad);
// then P V by wgmma m64n64k16 per 64 columns of D, with P's two bf16 terms
// as the A operand in registers (the score fragments are its A fragments)
// and V as the B operand from shared memory with the transpose bit, both
// terms into one fresh accumulator, folded in f32 (the fold kept: 5% faster
// at S4096 than accumulating into the output directly, PERF.md). The key
// loop runs from the window bound to the causal bound, so fully masked
// tiles are never loaded (the TPU kernel's pl.when skip); only tiles that
// straddle the causal, window or Sk edge of a warp's rows apply the mask.
// Rows past Sq are not stored. Tiles (WgLayout): D64 128 keys in two
// stages, D128 64 keys in three (128-key tiles at D128 left ptxas spilling
// the two-warpgroup consumers and ran B2 7% slower at S4096). NC is 2 when
// the grid of 128-row tiles fills the SMs, else 1 (fwd_groups): llama4's
// S128 has 40 tiles of 128 rows for 132 SMs, and 80 blocks of 64 rows
// finish sooner. With two consumer warpgroups the producer is a warpgroup
// whose registers setmaxnreg moves to the consumers (ptxas gives 384
// threads 168 registers each; the consumers then run at up to 240); with
// one it is a single warp. Registers, spills and the HGMMA and UTMALDG
// counts per instance are read by chip_smoke.py phase 1.
//
// attn_fwd_kernel (f32; bf16 at D 16/32/160): one block per (batch row, q
// head, 64-row q tile); 4 warps, each owning 16 q rows across the whole key
// tile (FlashAttention-2's layout), every product a warp-level mma.sync
// (mma.cuh): f32 as 3xTF32 m16n8k8 on each operand split as hi = tf32(x),
// lo = tf32(x - hi): lo*hi + hi*lo, then hi*hi (495 TFLOP/s a pass, three
// passes keep f32 accuracy); bf16 as m16n8k16. Key tiles: 32 rows in f32,
// 64 in bf16. Three parts, shared with the backward's mma.sync kernels
// (attn_ring.cuh):
//  - The ring. Thread 0 loads the q tile once and the K and V tiles by TMA
//    (cp.async.bulk.tensor, one copy a tile, a box of D + PAD columns whose
//    padding reads zeros, so the tiles keep their padded, conflict-free
//    rows; rows past Sq or Sk read zeros) into a ring of STAGES stages,
//    each with a full mbarrier and a count of the warps that have released
//    it. The last warp to release a stage refills it with the step STAGES
//    ahead: no block barrier in the key loop, a warp waits only for its
//    stage's bytes (a ring of 16-byte cp.async copies that met the whole
//    block at __syncthreads() every step ran slower, PERF.md).
//  - The fragments. S = Q K^T reads Q's and K's tf32 fragments by ldmatrix
//    (attn::scores: the same products in the same order as scalar reads,
//    so the same bits); P goes from the score's C fragments to the A
//    fragments of P V in registers (tf32: logical k t and t+4 read at
//    physical columns 2t and 2t+1, with V's B fragment read at rows 2t and
//    2t+1, mma.cuh), over 64-column slices of D, each in its own fresh
//    accumulator. V cannot go through ldmatrix (no 32-bit transpose): each
//    warp splits the V values it reads. f32 at D64 splits the q tile into
//    hi/lo once a block (Layout::PRE); at D128 that costs the second block
//    an SM, and each V tile split once for the four warps a block barrier
//    a step as well: both ran slower (PERF.md).
//  - The key split. Where the grid underfills the SMs (fwd_cluster: f32 at
//    D64/D128, B x Hq x q tiles below the SM count, four key tiles or more
//    a rank), the launch is clusters of c blocks per q tile
//    (attn_fwd_kernel<float, D, true, false>): rank r walks a contiguous,
//    near-equal share of the tile's key tiles with its own m, l and
//    accumulator, and after the loop the ranks' partials are combined
//    through distributed shared memory in rank order (combine());
//    flash-decoding's split, in one launch. No atomics, no partials in
//    device memory; a fixed order, so two runs give the same bits (another
//    order than the unsplit walk's, ROADMAP C); a cluster that cannot be
//    resident raises. Elsewhere, unless the grid is many short blocks
//    (fwd_halves), the block runs two warp groups of four warps
//    (attn_fwd_kernel<float, D, false, true>), each with its own ring
//    walking half of the key tiles, merged in rank order in shared
//    memory: the training shape's tail evens out.
// At D=128 f32 a block of two warp groups takes 169,152 bytes of shared
// memory, one block an SM (213 registers), a block of one 101,536 bytes,
// two blocks an SM (168 registers); no spills (the HMMA and UTMALDG
// counts: chip_smoke.py phase 1).
//
// Layouts: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), out like q, all
// contiguous and 16-byte aligned (TMA's bases); lse (B, Hq, Sq) f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include <cooperative_groups.h>

#include "attn_ring.cuh"
#include "attn_tile.cuh"
#include "mma.cuh"
#include "smem_opt_in.cuh"
#include "wgmma.cuh"

namespace {

using attn::aligned;
using attn::aligned128;
using attn::init_ring;
using attn::kLog2e;
using attn::Maps;
using attn::release;
using attn::Ring;
using attn::scores;
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

// Shared memory, in elements of T, after up to 128 bytes that align the
// base (TMA's destinations): the q tile (with PRE, its TF32 lo after it)
// and STAGES stages of (k, v) tiles for each warp group (two with HALVES),
// all rows of D + PAD, then each group's ring control (attn_ring.cuh).
template <typename T, int D, bool HALVES = false>
struct Layout {
  static constexpr int GROUPS = HALVES ? 2 : 1;
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int BK = Tile<T>::BK;
  static constexpr int LD = D + Tile<T>::PAD;
  static constexpr int STAGES = 2;
  // f32 at D64: q split into TF32 hi/lo once a block, a third more shared
  // memory (hymba's S1100 prefill 0.1628 -> 0.1328 ms, whisper's cross
  // attention 0.0313 -> 0.0299; at D128, where it leaves one block an SM
  // instead of two, B2 at S4096 took 3.286 ms against 2.809, H100 80GB
  // HBM3 at 700 W, PERF.md)
  static constexpr bool PRE = F32 && D == 64;
  static_assert(F32 || !PRE, "TF32 splits are f32's");
  static constexpr size_t q = size_t(BQ) * LD;
  static constexpr size_t stage = 2 * size_t(BK) * LD;
  static constexpr uint32_t q_bytes = uint32_t(q * sizeof(T));
  static constexpr uint32_t kv_bytes = uint32_t(BK * LD * sizeof(T));  // one k or v tile
  static constexpr size_t tiles = ((PRE ? 2 : 1) * q + GROUPS * STAGES * stage) * sizeof(T);
  static constexpr size_t bytes = 128 + tiles + GROUPS * attn::ring_ctl_bytes(STAGES);
  // a split launch's partial output and row statistics fit in a ring
  static_assert(q + 2 * BQ <= STAGES * stage, "the cluster's partials exceed the ring");
  static_assert((D / 2 + 4) * 32 * WARPS <= STAGES * stage, "a half's partials exceed its ring");
};

// acc (16 x D) = acc * corr + P V for the warp's rows: p the warp's scores
// after the softmax (NT 8-column C fragments over the key tile), V a BK-row
// tile of stride LD. Slices of CH 8-column tiles of D sum in a fresh
// accumulator each, folded with f32 fmas (corr[0] for row g, corr[1] for
// row g + 8). A slice's CH
// accumulators are its independent mma chains: up to 8 (64 columns, 32
// registers), the largest such divisor of the tile count; with 32-column
// slices B2 took 9% (f32) and 18% (bf16) longer on an H100 (PERF.md).
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

// The split launch's combine (CLUSTER), after every rank's key loop: each
// rank leaves its unnormalised output acc, and per row its running max m
// (log2 units) and its sum l, in its ring (free by then); rank r then
// combines rows r BQ / ranks .. (r + 1) BQ / ranks - 1 of the q tile from
// the n ranks that walked keys, in rank order: m = max m_r, w_r =
// 2^(m_r - m), l = sum l_r w_r, o = (sum acc_r w_r) / max(l, 1e-30), and
// writes them (and the lse row) once.
template <int D>
__device__ __forceinline__ void combine(float* part, float* wts, const float (&acc)[D / 8][4],
                                        const float (&m2)[2], const float (&l)[2], int n, int q0,
                                        float* __restrict__ o, float* __restrict__ lse, int Sq,
                                        int Hq, int h, int b) {
  constexpr int LD = Layout<float, D>::LD, W = attn::MAX_CLUSTER + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  auto cluster = cooperative_groups::this_cluster();
  const int ranks = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  float* pm = part + BQ * LD;  // per row: m, then l
  __syncthreads();             // every warp is done with the ring and the q tile
  attn::store_tile<LD>(part + warp * 16 * LD, acc, lane);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (t == 0) {
      pm[warp * 16 + g + 8 * r] = m2[r];
      pm[BQ + warp * 16 + g + 8 * r] = sum;
    }
  }
  cluster.sync();
  const float* parts[attn::MAX_CLUSTER];
#pragma unroll
  for (int rr = 0; rr < attn::MAX_CLUSTER; ++rr)
    parts[rr] = rr < n ? cluster.map_shared_rank(part, rr) : part;
  const int row0 = rank * BQ / ranks, rows = (rank + 1) * BQ / ranks - row0;
  // per row of the rank's slice: the n weights, then 1 / max(l, 1e-30)
  for (int i = tid; i < rows; i += THREADS) {
    const int row = row0 + i;
    float mr[attn::MAX_CLUSTER], lr[attn::MAX_CLUSTER];
#pragma unroll
    for (int rr = 0; rr < attn::MAX_CLUSTER; ++rr)
      if (rr < n) {
        mr[rr] = parts[rr][BQ * LD + row];
        lr[rr] = parts[rr][BQ * LD + BQ + row];
      }
    float m = mr[0];
#pragma unroll
    for (int rr = 1; rr < attn::MAX_CLUSTER; ++rr)
      if (rr < n) m = fmaxf(m, mr[rr]);
    float sum = 0.f;
#pragma unroll
    for (int rr = 0; rr < attn::MAX_CLUSTER; ++rr)
      if (rr < n) {
        const float w = exp2f(mr[rr] - m);
        wts[i * W + rr] = w;
        sum = rr == 0 ? lr[rr] * w : fmaf(lr[rr], w, sum);
      }
    const float denom = fmaxf(sum, 1e-30f);
    wts[i * W + attn::MAX_CLUSTER] = __fdividef(1.f, denom);
    if (lse != nullptr && q0 + row < Sq)
      lse[(size_t(b) * Hq + h) * Sq + q0 + row] = fmaf(m, kLn2, logf(denom));
  }
  __syncthreads();
  float* oh = o + (size_t(b) * Sq * Hq + h) * D;
  for (int i = tid; i < rows * (D / 2); i += THREADS) {
    const int r = i / (D / 2), col = 2 * (i % (D / 2)), row = row0 + r;
    if (q0 + row >= Sq) continue;
    const int at = row * LD + col;
    float2 x[attn::MAX_CLUSTER];
#pragma unroll
    for (int rr = 0; rr < attn::MAX_CLUSTER; ++rr)
      if (rr < n) x[rr] = *reinterpret_cast<const float2*>(parts[rr] + at);
    float2 a = make_float2(x[0].x * wts[r * W], x[0].y * wts[r * W]);
#pragma unroll
    for (int rr = 1; rr < attn::MAX_CLUSTER; ++rr)
      if (rr < n) {
        a.x = fmaf(x[rr].x, wts[r * W + rr], a.x);
        a.y = fmaf(x[rr].y, wts[r * W + rr], a.y);
      }
    const float inv = wts[r * W + attn::MAX_CLUSTER];
    mma::store_pair(oh + size_t(q0 + row) * Hq * D + col, a.x * inv, a.y * inv);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The key range of a q tile is split in ranks, each a contiguous,
// near-equal share of its key tiles (the first n = min(ranks, the tile's
// key tiles) ranks take one or more), combined in rank order: CLUSTER, the
// block is rank r of a cluster of c along grid x that shares its q tile
// (blockIdx.x / c), merged by combine(); HALVES, the block's two warp
// groups of WARPS warps are ranks 0 and 1, each with its own ring, merged
// in shared memory by group 0.
template <typename T, int D, bool CLUSTER, bool HALVES>
__global__ void __launch_bounds__(Layout<T, D, HALVES>::GROUPS * THREADS)
attn_fwd_kernel(const __grid_constant__ Maps maps, T* __restrict__ o, float* __restrict__ lse,
                int Sq, int Sk, int Hq, int Hkv, int causal, int window, float scale) {
  using L = Layout<T, D, HALVES>;
  constexpr int BK = L::BK, LD = L::LD, ST = L::STAGES;
  constexpr int NT = BK / 8;  // 8-column tiles of a warp's scores
  constexpr int ND = D / 8;   // 8-column tiles of a warp's output
  static_assert(!(CLUSTER || HALVES) || L::F32, "K1/B2 split their keys in f32 only");
  static_assert(!(CLUSTER && HALVES), "one split at a time");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = aligned128(smem_raw);
  T* Qs = reinterpret_cast<T*>(base);       // BQ x LD
  T* Qlo = Qs + L::q;                       // PRE: BQ x LD
  T* ring0 = Qs + (L::PRE ? 2 : 1) * L::q;  // group 0's stage s: k at + s * stage, v after it
  const Ring rc0 = init_ring<ST>(base + L::tiles);
  const Ring rc1 = HALVES ? init_ring<ST>(base + L::tiles + attn::ring_ctl_bytes(ST)) : rc0;

  const int group = HALVES ? int(threadIdx.x) / THREADS : 0;
  const int tid = threadIdx.x % THREADS, lane = tid & 31, warp = tid >> 5;  // in the group
  const int g = lane >> 2, t = lane & 3;
  T* ring = ring0 + group * ST * L::stage;
  const Ring rc = group ? rc1 : rc0;
  const int ranks = CLUSTER ? int(cooperative_groups::this_cluster().num_blocks()) : L::GROUPS;
  const int rank = CLUSTER ? int(cooperative_groups::this_cluster().block_rank()) : group;
  const int per_tile = CLUSTER ? ranks : 1;  // blocks along x a q tile
  const int qt = gridDim.x / per_tile - 1 - blockIdx.x / per_tile;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int r0 = q0 + warp * 16;  // the warp's first row

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  const int tiles = k_end > k_begin ? (k_end + BK - 1) / BK - k_begin / BK : 0;
  // the rank's share of the key tiles (all of them unsplit)
  const int n = max(1, min(ranks, tiles));
  const int first = rank < n ? rank * tiles / n : tiles;
  const int steps = (rank < n ? (rank + 1) * tiles / n : tiles) - first;
  const int t_begin = k_begin / BK + first;

  // the block reads its q tile if any of its ranks walks keys (rank 0
  // does, if any does)
  const bool loads = HALVES ? tiles > 0 : steps > 0;

  // step `step`'s k and v tiles into its group's stage (one thread)
  auto issue = [&](int step) {
    const int s = step % ST, k0 = (t_begin + step) * BK;
    const uint32_t st = mma::smem_addr(ring + s * L::stage);
    wg::mbar_arrive_expect(rc.full(s), 2 * L::kv_bytes);
    wg::tma_load_4d(st, &maps.k, rc.full(s), 0, hk, k0, b);
    wg::tma_load_4d(st + L::kv_bytes, &maps.v, rc.full(s), 0, hk, k0, b);
  };
  if (threadIdx.x == 0 && loads) {  // the q tile, completing on group 0's ring
    wg::mbar_arrive_expect(rc0.bar, L::q_bytes);
    wg::tma_load_4d(mma::smem_addr(Qs), &maps.q, rc0.bar, 0, h, q0, b);
  }
  if (tid == 0)
    for (int i = 0; i < ST && i < steps; ++i) issue(i);

  // rows g and g + 8 of the warp's 16: running max (log2 units) and this
  // thread's share of the row sum (its columns; the quad's shares are
  // added at the end)
  float m2[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[ND][4] = {};
  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  if (loads) {
    wg::mbar_wait(rc0.bar, 0);
    if constexpr (L::PRE) {  // q into tf32 hi (in place) and lo, once
      attn::split_rows<D, LD, L::GROUPS * THREADS>(Qs, Qlo, BQ);
      __syncthreads();
    }
  }
  for (int step = 0; step < steps; ++step) {
    const int s = step % ST;
    wg::mbar_wait(rc.full(s), (step / ST) & 1);  // this step's tiles are in
    const int k0 = (t_begin + step) * BK;
    const T* Kt = ring + s * L::stage;
    const T* Vt = Kt + BK * LD;

    float sc[NT][4];
    scores<D, LD, NT, L::PRE>(sc, Qs + warp * 16 * LD, Qlo + warp * 16 * LD, Kt, lane);
    auto scale_mask = [&](auto whole) {  // scaled scores in log2 units
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = r0 + g + 8 * (e >> 1);
          const int kp = k0 + 8 * i + 2 * t + (e & 1);
          sc[i][e] = (decltype(whole)::value || visible(qp, kp, Sk, causal, window))
                         ? sc[i][e] * scale2
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
      for (int i = 0; i < NT; ++i) mx = fmaxf(mx, fmaxf(sc[i][2 * r], sc[i][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = exp2f(m2[r] - mx);
      m2[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(sc[i][2 * r + c] - mx);
          sc[i][2 * r + c] = p;
          sum += p;
        }
      l[r] = fmaf(l[r], corr[r], sum);
    }
    pv<D, LD, NT>(acc, sc, corr, Vt, lane);
    __syncwarp();  // the warp is done with the stage
    if (lane == 0 && release<WARPS>(rc, s) && step + ST < steps) {
      mma::fence_proxy_async();
      issue(step + ST);
    }
  }

  if constexpr (CLUSTER) {
    combine<D>(reinterpret_cast<float*>(ring), reinterpret_cast<float*>(Qs), acc, m2, l, n, q0, o,
               lse, Sq, Hq, h, b);
    return;
  }
  float rsum[2];  // the rows' sums (the quad's shares added)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rsum[r] = l[r];
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
  }
  if constexpr (HALVES) {
    // group 1 leaves its acc, m and row sums in its ring, each thread's
    // values at its own index; group 0 merges them into its own in rank
    // order, as combine() does, and stores the rows
    float* part = reinterpret_cast<float*>(ring0 + ST * L::stage);
    if (group == 1) {
      mma::named_sync(1, THREADS);  // every warp of group 1 is done with its ring
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(4 * i + e) * THREADS + tid] = acc[i][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        part[(4 * ND + r) * THREADS + tid] = m2[r];
        part[(4 * ND + 2 + r) * THREADS + tid] = rsum[r];
      }
    }
    __syncthreads();
    if (group == 1) return;
    if (n == 2) {
      float w0[2], w1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = part[(4 * ND + r) * THREADS + tid];
        const float m = fmaxf(m2[r], m1);
        w0[r] = exp2f(m2[r] - m);
        w1[r] = exp2f(m1 - m);
        rsum[r] = fmaf(part[(4 * ND + 2 + r) * THREADS + tid], w1[r], rsum[r] * w0[r]);
        m2[r] = m;
      }
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][e] = fmaf(part[(4 * i + e) * THREADS + tid], w1[e >> 1], acc[i][e] * w0[e >> 1]);
    }
  }
  T* oh = o + (size_t(b) * Sq * Hq + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = rsum[r];
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

// A block per (BQ q rows, q head, row), times its cluster along x.
dim3 fwd_grid(int B, int Sq, int Hq, int cluster = 1) {
  return dim3(cluster * ((Sq + BQ - 1) / BQ), Hq, B);
}

// f32 K1/B2's cluster at D 64 and 128: where the grid of (q tile, q head,
// row) blocks underfills the SMs, the largest c at most MAX_CLUSTER that
// leaves each rank at least FWD_RANK_TILES of the 32-key tiles of Sk; 1
// (no split) otherwise, and always in bf16. A rank pays for its own q tile
// and the combine, about what four key tiles cost: at 11b's S128 (four key
// tiles, 80 blocks) B2 took 0.0172 ms unsplit against 0.0214 in two ranks
// and 0.0240 in four, while whisper's cross attention (47 key tiles) fell
// from 0.0862 to 0.0313 ms in eight ranks (B1 Sq128) and from 0.0874 to
// 0.0557 in eight (B4 Sq4; 0.0594 in six; an H100 80GB HBM3 at 700 W,
// PERF.md). Fewer than SM-count blocks split at most eight ways stay
// within eight waves of the SMs. A causal tile with fewer key tiles than
// ranks leaves the last ranks idle. A fixed function of the sizes and the
// SM count (the plan query sees no mask), so two launches combine in the
// same order.
constexpr int FWD_RANK_TILES = 4;
int fwd_cluster(int B, int Sq, int Sk, int Hq, int D, bool f32) {
  const long blocks = long(B) * Hq * ((Sq + BQ - 1) / BQ);
  const int key_tiles = (Sk + Tile<float>::BK - 1) / Tile<float>::BK;
  if (!f32 || (D != 64 && D != 128) || blocks >= wg::sm_count()) return 1;
  return std::max(1, std::min(attn::MAX_CLUSTER, key_tiles / FWD_RANK_TILES));
}

// Whether f32 K1/B2 at D 64 and 128 splits each q tile's key range in two
// inside the block instead (HALVES: two warp groups of four warps, each
// with its own ring, one block an SM): where fwd_cluster does not split,
// Sk has two key tiles or more, and either the grid fills fewer than four
// waves of the SMs or the key range spans FWD_HALVES_TILES key tiles or
// more. Half the steps a block evens out the causal tail: B2 at S4096 took
// 2.608 ms against 2.790 in blocks of four warps, K1 at S2048 0.730
// against 0.802, 11b's B1 S128 (80 blocks) 0.0146 against 0.0172; only
// short blocks past four waves lose their second block an SM (11b's B8
// S128, 640 blocks of four key tiles: 0.0639 against 0.0593; an H100
// 80GB HBM3 at 700 W, PERF.md).
constexpr int FWD_HALVES_TILES = 8;
bool fwd_halves(int B, int Sq, int Sk, int Hq, int D, bool f32) {
  const long blocks = long(B) * Hq * ((Sq + BQ - 1) / BQ);
  const int key_tiles = (Sk + Tile<float>::BK - 1) / Tile<float>::BK;
  return f32 && (D == 64 || D == 128) && key_tiles >= 2 &&
         (blocks < 4 * wg::sm_count() || key_tiles >= FWD_HALVES_TILES) &&
         fwd_cluster(B, Sq, Sk, Hq, D, f32) == 1;
}

// The mma.sync kernel's tensor maps: q in boxes of BQ rows, k and v of BK,
// each D + PAD columns wide (the padding reads zeros). With no keys, k's
// and v's maps point at q: nothing reads them.
template <typename T, int D>
cudaError_t make_maps(Maps* m, const void* q, const void* k, const void* v, int B, int Sq, int Sk,
                      int Hq, int Hkv) {
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr int cols = D + Tile<T>::PAD, bk = Tile<T>::BK;
  if (Sk <= 0) k = v = q, Sk = 1;
  cudaError_t err =
      wg::map_box(&m->q, q, f32, B, Sq, Hq, D, cols, BQ, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = wg::map_box(&m->k, k, f32, B, Sk, Hkv, D, cols, bk, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = wg::map_box(&m->v, v, f32, B, Sk, Hkv, D, cols, bk, CU_TENSOR_MAP_SWIZZLE_NONE);
  return err;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Sk, int Hq, int Hkv, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D>::bytes;
  static_assert(smem <= kMaxSmem, "the forward's tiles exceed the shared memory of a block");
  Maps maps = {};
  cudaError_t err = make_maps<T, D>(&maps, q, k, v, B, Sq, Sk, Hq, Hkv);
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, float>::value && (D == 64 || D == 128)) {
    const int c = fwd_cluster(B, Sq, Sk, Hq, D, true);
    if (c > 1) {
      auto kernel = attn_fwd_kernel<float, D, true, false>;
      static SmemOptIn opt_in;                    // one per kernel instance
      static std::atomic<unsigned> resident{0};  // bit c: clusters of c fit
      err = opt_in_smem(opt_in, kernel, smem);
      if (err != cudaSuccess) return err;
      return attn::launch_clusters(kernel, resident, fwd_grid(B, Sq, Hq, c), THREADS, smem,
                                   stream, c, maps, static_cast<float*>(o), lse, Sq, Sk, Hq, Hkv,
                                   causal, window, scale);
    }
    if (fwd_halves(B, Sq, Sk, Hq, D, true)) {
      constexpr size_t halves = Layout<float, D, true>::bytes;
      static_assert(halves <= kMaxSmem, "the split block's tiles exceed its shared memory");
      static SmemOptIn opt_in;  // one per kernel instance
      err = opt_in_smem(opt_in, attn_fwd_kernel<float, D, false, true>, halves);
      if (err != cudaSuccess) return err;
      attn_fwd_kernel<float, D, false, true><<<fwd_grid(B, Sq, Hq), 2 * THREADS, halves, stream>>>(
          maps, static_cast<float*>(o), lse, Sq, Sk, Hq, Hkv, causal, window, scale);
      return cudaGetLastError();
    }
  }
  static SmemOptIn opt_in;  // one per kernel instance
  err = opt_in_smem(opt_in, attn_fwd_kernel<T, D, false, false>, smem);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<T, D, false, false><<<fwd_grid(B, Sq, Hq), THREADS, smem, stream>>>(
      maps, static_cast<T*>(o), lse, Sq, Sk, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

// ------------------------------------------- bf16 at D 64/128: wgmma fed by TMA

// The wgmma kernel's tiles: NC consumer warpgroups of 64 q rows each, then
// the producer; key tiles of BK rows in a ring of STAGES. Shared memory: the
// q tile (D / 64 swizzled tiles of BQ x 64), then per stage K's and V's
// (D / 64 tiles of BK x 64 each), then the mbarriers, after up to 1024
// bytes that align the base for the swizzle. D128 takes 64-key tiles in
// three stages: 128-key tiles ran B2 7% slower at S4096 and left the
// consumers spilling (PERF.md).
template <int D, int NC>
struct WgLayout {
  static constexpr int BQ = 64 * NC;
  static constexpr int BK = D == 128 ? 64 : 128;
  static constexpr int STAGES = D == 128 ? 3 : 2;
  // one block an SM. With one consumer warpgroup the producer is a warp,
  // and the launch bound leaves every thread up to 255 registers; with two
  // it is a warpgroup (ptxas allocates registers by warpgroup: 168 a thread
  // for 288 or 384 threads), whose registers setmaxnreg moves to the
  // consumers: 24 a producer thread, 240 a consumer thread, 168 x 384 in all
  static constexpr int THREADS = NC == 2 ? 384 : 160;
  static constexpr uint32_t q = uint32_t(BQ) * D * 2;
  static constexpr uint32_t kv = uint32_t(BK) * D * 2;  // K or V of one stage
  static constexpr uint32_t bars = q + STAGES * 2 * kv;
  static constexpr int NBAR = 1 + 3 * STAGES;  // q full; per stage K full, V full, empty
  static constexpr size_t bytes = 1024 + bars + 8 * NBAR;
};

// What the producer and the consumers of one block share: shared-memory
// addresses of the q tile, the ring (stage s: K at ring + 2 s kv, V after
// it) and the mbarriers (q full, then per stage K full, V full, and empty:
// 4 NC arrivals, lane 0 of each consumer warp), and the block's tiles.
struct WgBlock {
  uint32_t qs, ring, bar;
  int q0, t_begin, steps, h, b;
};

template <int ST>
__device__ __forceinline__ uint32_t bar_k(const WgBlock& blk, int s) {
  return blk.bar + 8 * (1 + s);
}
template <int ST>
__device__ __forceinline__ uint32_t bar_v(const WgBlock& blk, int s) {
  return blk.bar + 8 * (1 + ST + s);
}
template <int ST>
__device__ __forceinline__ uint32_t bar_empty(const WgBlock& blk, int s) {
  return blk.bar + 8 * (1 + 2 * ST + s);
}

// The producer's one thread: the q tile once, then K and V of each key
// tile into its stage once every consumer warp has released it.
template <int D, int NC>
__device__ __forceinline__ void wg_produce(const WgBlock& blk, const CUtensorMap* tq,
                                           const CUtensorMap* tk, const CUtensorMap* tv, int hk) {
  using L = WgLayout<D, NC>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::STAGES;
  wg::mbar_arrive_expect(blk.bar, L::q);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    wg::tma_load_4d(blk.qs + c * BQ * 128, tq, blk.bar, 64 * c, blk.h, blk.q0, blk.b);
  for (int i = 0; i < blk.steps; ++i) {
    const int s = i % ST;
    if (i >= ST) wg::mbar_wait(bar_empty<ST>(blk, s), ((i / ST) - 1) & 1);
    const int k0 = (blk.t_begin + i) * BK;
    const uint32_t ks = blk.ring + 2 * s * L::kv, vs = ks + L::kv;
    wg::mbar_arrive_expect(bar_k<ST>(blk, s), L::kv);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      wg::tma_load_4d(ks + c * BK * 128, tk, bar_k<ST>(blk, s), 64 * c, hk, k0, blk.b);
    wg::mbar_arrive_expect(bar_v<ST>(blk, s), L::kv);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      wg::tma_load_4d(vs + c * BK * 128, tv, bar_v<ST>(blk, s), 64 * c, hk, k0, blk.b);
  }
}

// Consumer warpgroup w: q rows q0 + 64 w .. q0 + 64 w + 63, over every key
// tile of the block, then its output rows (and lse rows when asked).
template <int D, int NC>
__device__ __forceinline__ void wg_consume(const WgBlock& blk, int w, bf16* __restrict__ o,
                                           float* __restrict__ lse, int Sq, int Sk, int Hq,
                                           int causal, int window, float scale) {
  using L = WgLayout<D, NC>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::STAGES;
  constexpr int NS = BK / 8;  // 8-column tiles of a warp's scores
  constexpr int NO = D / 8;   // 8-column tiles of a warp's output
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq4 = lane & 3;
  const int rw = blk.q0 + 64 * w + 16 * warp;  // the warp's first row
  const uint32_t q_desc = wg::desc_lo(blk.qs + w * 64 * 128, 16);  // the warpgroup's rows

  // rows g and g + 8 of the warp's 16: running max (log2 units) and this
  // thread's share of the row sum (the quad's shares are added at the end)
  float m2[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  if (blk.steps > 0) wg::mbar_wait(blk.bar, 0);
  for (int i = 0; i < blk.steps; ++i) {
    const int s = i % ST;
    const uint32_t phase = (i / ST) & 1;
    const int k0 = (blk.t_begin + i) * BK;
    const uint32_t ks = blk.ring + 2 * s * L::kv, vs = ks + L::kv;

    // s = Q K^T: D / 16 k steps, each 32 bytes further along the rows (the
    // next 64 columns in the next swizzled tile)
    float sc[BK / 2];
    const uint32_t k_desc = wg::desc_lo(ks, 16);
    wg::mbar_wait(bar_k<ST>(blk, s), phase);
    wg::fence();
    wg::static_for<0, D / 16>([&](auto kk) {
      constexpr int K = decltype(kk)::value, c = K / 4, step = 2 * (K % 4);  // 16-byte units
      wg::mma_ss<c * BQ * 8 + step, c * BK * 8 + step, (K > 0)>(sc, q_desc, k_desc);
    });
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(sc);

    auto scale_mask = [&](auto whole) {  // scaled scores in log2 units
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = rw + g + 8 * (e >> 1);
          const int kp = k0 + 8 * j + 2 * tq4 + (e & 1);
          sc[4 * j + e] = (decltype(whole)::value || visible(qp, kp, Sk, causal, window))
                              ? sc[4 * j + e] * scale2
                              : kMasked;
        }
    };
    // a key tile that every row of the warp sees skips the mask
    if (k0 + BK <= Sk && (!causal || k0 + BK - 1 <= rw) &&
        (window <= 0 || rw + 15 - k0 < window))
      scale_mask(std::true_type{});
    else
      scale_mask(std::false_type{});

    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m2[r];
#pragma unroll
      for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = exp2f(m2[r] - mx);
      m2[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(sc[4 * j + 2 * r + c] - mx);
          sc[4 * j + 2 * r + c] = p;
          sum += p;
        }
      l[r] = fmaf(l[r], corr[r], sum);
    }

    // P in two bf16 terms, as the A operand of k step j (keys 16j ..
    // 16j + 15: score tiles 2j and 2j + 1)
    uint32_t phi[BK / 16][4], plo[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int a = 0; a < 4; ++a)
        split_bf16(sc[8 * j + 2 * a], sc[8 * j + 2 * a + 1], phi[j][a], plo[j][a]);

    // the tile's P V per 64 columns of D, each in a fresh accumulator (p_lo
    // V, then p_hi V, per k step of 16 keys: 2048 bytes of V), folded
    const uint32_t v_desc = wg::desc_lo(vs, BK * 128);
    wg::mbar_wait(bar_v<ST>(blk, s), phase);
    wg::static_for<0, D / 64>([&](auto cc) {
      constexpr int c = decltype(cc)::value;
      float part[32];
      wg::fence();
      wg::static_for<0, BK / 16>([&](auto jj) {
        constexpr int j = decltype(jj)::value;
        wg::mma_rs<c * BK * 8 + j * 128, (j > 0)>(part, plo[j], v_desc);
        wg::mma_rs<c * BK * 8 + j * 128, 1>(part, phi[j], v_desc);
      });
      wg::commit();
      wg::wait<0>();
      wg::fence_operand(part);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[32 * c + 4 * j + e] = fmaf(acc[32 * c + 4 * j + e], corr[e >> 1], part[4 * j + e]);
    });
    if (lane == 0) wg::mbar_arrive(bar_empty<ST>(blk, s));  // this warp is done with the stage
  }

  bf16* oh = o + (size_t(blk.b) * Sq * Hq + blk.h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qp = rw + g + 8 * r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(sum, 1e-30f);
    if (lse != nullptr && tq4 == 0)
      lse[(size_t(blk.b) * Hq + blk.h) * Sq + qp] = fmaf(m2[r], kLn2, logf(denom));
    const float inv = __fdividef(1.f, denom);
    bf16* row = oh + size_t(qp) * Hq * D + 2 * tq4;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      mma::store_pair(row + 8 * j, acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
  }
}

template <int D, int NC>
__global__ void __launch_bounds__(WgLayout<D, NC>::THREADS, 1)
attn_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int causal,
                      int window, float scale) {
  using L = WgLayout<D, NC>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = mma::smem_addr(smem_raw);
  WgBlock blk;
  blk.qs = raw + (1024 - raw % 1024) % 1024;
  blk.ring = blk.qs + L::q;
  blk.bar = blk.qs + L::bars;
  blk.h = blockIdx.y;
  blk.b = blockIdx.z;
  blk.q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int k_end = causal ? min(Sk, blk.q0 + BQ) : Sk;
  const int k_begin = (causal && window > 0) ? max(0, blk.q0 - window + 1) : 0;
  blk.t_begin = k_begin / BK;
  blk.steps = k_end > k_begin ? (k_end + BK - 1) / BK - blk.t_begin : 0;

  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + (blk.bar - raw));
    for (int i = 0; i < L::NBAR; ++i) mma::mbar_init(bars + i, i < 1 + 2 * ST ? 1 : 4 * NC);
    mma::mbar_fence_init();
  }
  __syncthreads();

  // the thread's warpgroup, read from lane 0 so that the compiler sees it
  // uniform across each warp: consumers 0 .. NC - 1, then the producer
  const int role = __shfl_sync(0xffffffffu, int(threadIdx.x) >> 7, 0);
  if (role == NC) {
    if constexpr (NC == 2) wg::regs_dec<24>();
    if (threadIdx.x == 128 * NC && blk.steps > 0)
      wg_produce<D, NC>(blk, &tq, &tk, &tv, blk.h / (Hq / Hkv));
  } else {
    if constexpr (NC == 2) wg::regs_inc<240>();
    wg_consume<D, NC>(blk, role, o, lse, Sq, Sk, Hq, causal, window, scale);
  }
}

// Consumer warpgroups a block of the wgmma kernel: 2 (128 q rows) when the
// grid of 128-row tiles fills the SMs, else 1 (64 rows, twice the blocks).
int fwd_groups(int B, int Sq, int Hq) { return wg::groups(long(B) * Hq, Sq); }

dim3 wgmma_grid(int B, int Sq, int Hq, int NC) {
  return dim3((Sq + 64 * NC - 1) / (64 * NC), Hq, B);
}

template <int D, int NC>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                         int Sq, int Sk, int Hq, int Hkv, int causal, int window, float scale,
                         cudaStream_t stream) {
  using L = WgLayout<D, NC>;
  static_assert(L::bytes <= kMaxSmem, "the forward's tiles exceed the shared memory of a block");
  CUtensorMap tq, tk, tv;
  cudaError_t err = wg::map_rows(&tq, q, B, Sq, Hq, D, L::BQ);
  if (err == cudaSuccess) err = wg::map_rows(&tk, k, B, std::max(Sk, 1), Hkv, D, L::BK);
  if (err == cudaSuccess) err = wg::map_rows(&tv, v, B, std::max(Sk, 1), Hkv, D, L::BK);
  if (err != cudaSuccess) return err;
  static SmemOptIn opt_in;  // one per kernel instance
  err = opt_in_smem(opt_in, attn_fwd_kernel_wgmma<D, NC>, L::bytes);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel_wgmma<D, NC><<<wgmma_grid(B, Sq, Hq, NC), L::THREADS, L::bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, Sq, Sk, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma_d(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                         int Sq, int Sk, int Hq, int Hkv, int causal, int window, float scale,
                         cudaStream_t stream) {
  return fwd_groups(B, Sq, Hq) == 2
             ? launch_wgmma<D, 2>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, window, scale,
                                  stream)
             : launch_wgmma<D, 1>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, window, scale,
                                  stream);
}

// The (dtype, D) rule of the header: bf16 at D 64 and 128 runs the wgmma
// kernel, everything else the mma.sync one.
template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Sq, int Sk, int Hq, int Hkv, int D, int causal, int window,
                       float scale, cudaStream_t stream) {
#define REPRO_FWD_CASE(DIM) \
  case DIM:                 \
    return launch<T, DIM>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, window, scale, stream);
#define REPRO_FWD_WGMMA_CASE(DIM)                                                                \
  case DIM:                                                                                      \
    if constexpr (std::is_same<T, bf16>::value)                                                  \
      return launch_wgmma_d<DIM>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, window, scale,     \
                                 stream);                                                        \
    else                                                                                         \
      return launch<T, DIM>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, window, scale, stream);
  switch (D) {  // HEAD_DIMS of kernels/flash_attention.py
    REPRO_FWD_CASE(16)
    REPRO_FWD_CASE(32)
    REPRO_FWD_WGMMA_CASE(64)
    REPRO_FWD_WGMMA_CASE(128)
    REPRO_FWD_CASE(160)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FWD_WGMMA_CASE
#undef REPRO_FWD_CASE
}

// The launch of K1/B2 for these sizes: grid, threads, shared bytes,
// cluster.
template <typename T>
int fwd_plan(int B, int Sq, int Sk, int Hq, int D, int64_t* out) {
  size_t smem = 0;
  int threads = THREADS, c = 1;
  dim3 g;
  if (std::is_same<T, bf16>::value && (D == 64 || D == 128)) {
    const int nc = fwd_groups(B, Sq, Hq);
    g = wgmma_grid(B, Sq, Hq, nc);
    threads = nc == 2 ? WgLayout<64, 2>::THREADS : WgLayout<64, 1>::THREADS;
    smem = D == 64 ? (nc == 2 ? WgLayout<64, 2>::bytes : WgLayout<64, 1>::bytes)
                   : (nc == 2 ? WgLayout<128, 2>::bytes : WgLayout<128, 1>::bytes);
  } else {
    constexpr bool f32 = std::is_same<T, float>::value;
    const bool halves = fwd_halves(B, Sq, Sk, Hq, D, f32);
    switch (D) {  // HEAD_DIMS of kernels/flash_attention.py
      case 16: smem = Layout<T, 16>::bytes; break;
      case 32: smem = Layout<T, 32>::bytes; break;
      case 64: smem = halves ? Layout<T, 64, true>::bytes : Layout<T, 64>::bytes; break;
      case 128: smem = halves ? Layout<T, 128, true>::bytes : Layout<T, 128>::bytes; break;
      case 160: smem = Layout<T, 160>::bytes; break;
      default: return cudaErrorInvalidValue;
    }
    c = fwd_cluster(B, Sq, Sk, Hq, D, f32);
    threads = halves ? 2 * THREADS : THREADS;
    g = fwd_grid(B, Sq, Hq, c);
  }
  const int64_t v[6] = {g.x, g.y, g.z, threads, int64_t(smem), c};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return cudaSuccess;
}

cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
                int Sk, int Hq, int Hkv, int D, int causal, int window, float scale, int dtype,
                void* stream) {
  if (Sq <= 0 || B <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  // TMA's 16-byte bases of q, k, v; paired stores of o
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

// The launch repro_flash_attention_fwd(_lse) makes for these sizes, by the
// same fwd_grid, fwd_cluster and Layout: out = grid x, y, z, threads,
// dynamic shared bytes, cluster x. Launches nothing.
extern "C" int repro_flash_attention_fwd_plan(int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                              int dtype, int64_t* out) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  return dtype == 0 ? fwd_plan<float>(B, Sq, Sk, Hq, D, out)
         : dtype == 1 ? fwd_plan<bf16>(B, Sq, Sk, Hq, D, out)
                      : cudaErrorInvalidValue;
}
