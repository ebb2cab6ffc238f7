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
// cores, not the FMA units (67 TFLOP/s f32). P and dS enter the second
// products rounded once to bf16 in bf16, as FlashAttention-2 does; the
// reference keeps them in f32 (a deliberate difference, ROADMAP C).
//
// Which kernels run is a fixed rule on (dtype, D), in dispatch() and
// bwd_plan(), as the forward's (flash_attention.cu):
//  - bf16 at D 64 and 128 (granite, qwen2.5, llama4 at D128, whisper at
//    D64): attn_dq_kernel_wgmma and attn_dkv_kernel_wgmma, Hopper's
//    warpgroup products fed by TMA (below; the bf16 D64/D128 instances of
//    the mma.sync kernels are not built);
//  - f32 at any D, and bf16 at D 16, 32 and 160 (stablelm-12b trains at
//    D160 in f32, chip_smoke.py phase 6e; no configuration trains in bf16
//    at D 16, 32 or 160): attn_dq_kernel and attn_dkv_kernel, warp-level
//    mma.sync (mma.cuh). TF32 wgmma takes both operands K-major, so ds K
//    would need K transposed in shared memory, and 3xTF32 three passes of
//    it: the f32 path stays on mma.sync.
// A launch error raises in the wrapper; nothing falls back to another
// kernel.
//
// The wgmma kernels (bf16, D 64/128): a block of NC consumer warpgroups of
// 64 rows each (B3: q rows, Q and dO resident; B4: key rows, K and V
// resident), then a producer; NC is 2 when the grid of 128-row tiles fills
// the SMs, else 1 (wg::groups, shared with the forward). One producer
// thread streams the other operand's 64-row tiles (B3: K, V; B4: Q, dO)
// through a two-stage ring by TMA from 4-D tensor maps over (D, H, S, B),
// boxes of 64 columns, 128-byte swizzle (rows past S zero-filled by the
// hardware, never read from the next batch row), each stage with two full
// mbarriers and an empty one that every consumer warp releases. B4's
// producer is a warp: its lanes copy each step's lse and delta rows into
// shared memory with ordinary loads, since (B, Hq, Sq) f32 rows cannot be
// mapped when Sq % 4 != 0 (a map's strides are multiples of 16 bytes). No
// tile is transposed in shared memory: the score products take both
// operands K-major, the second products their A (p or ds, packed to bf16
// from the accumulator fragments) from registers and their B MN-major by
// wgmma's transpose bit; B4 computes S^T = K Q^T and dP^T = V dO^T so that
// p^T and ds^T are A fragments (see the section's notes below). The
// backward has no online rescale, so dQ, dK and dV accumulate on the tensor
// cores directly, with no per-tile fold (the f32 path's 1e-4 gate needed
// one, below; the bf16 gate is 2e-2). Only tiles that straddle the causal,
// window or sequence edge of a warp's rows apply the mask; rows past Sq/Sk
// are not stored; a block whose rows see no key writes zeros.
//
// The mma.sync kernels (f32; bf16 at D 16/32/160): 256 threads, 8 warps; a
// block keeps 64 resident rows (B3: its q and dO tile; B4: its k and v
// tile) in shared memory and streams tiles of the other operand (B3: k, v;
// B4: q, dO) through a two-stage ring of TMA copies, one per tile: a box of
// D + PAD columns, whose columns past D read zeros, lands as the padded
// rows the fragment reads want (Maps, in attn_ring.cuh with the ring
// and the score products the forward shares). Each stage has a full mbarrier and
// a count of the warps that have released it; the warp whose release is
// the last refills the stage with the step two ahead, so the copy overlaps
// a step's products and no warp waits for another to refill, only for a
// stage's bytes to land (16-byte cp.async by all 256 threads behind two
// block barriers a step ran B3 12% slower at S4096). Rows past the end
// read zeros and are masked. B4 reads each step's lse and delta into
// registers before its score products. Every product is a warp-level
// mma.sync: bf16 m16n8k16 with f32 accumulators; f32 as
// 3xTF32, m16n8k8 on each operand split as hi = tf32(x), lo = tf32(x -
// hi): lo*hi + hi*lo, then hi*hi; three passes at 495 TFLOP/s keep f32
// accuracy (single TF32 keeps ~3 digits, too few for the training gates).
// The f32 score products read their fragments by ldmatrix (scores()), and
// f32 B4 at D128 splits its resident k and v into hi and lo once per block
// (Layout::PRE), where the step split them again for every product.
// Warps pair up on 16 resident rows: for the scores, each warp of the pair
// takes half of the streamed columns and writes its p / ds block to shared
// memory; after a barrier of the pair (a named barrier of 64 threads, one
// before the write so that the other warp has read the last step's), each
// warp of the pair accumulates half of the head dim's columns (dq, or dk
// and dv) from the pair's whole p / ds rows, so the accumulators take 32
// (B3) or 64 (B4) registers a thread at D=128.
//
// Shared memory and bank conflicts (mma.sync): rows are padded to D+4
// floats or D+8 halves, so fragment reads are conflict-free: in f32 with
// 32-bit loads (the transposed operand read at rows 2t and 2t+1, see
// mma.cuh), in bf16 with 32-bit loads and ldmatrix.trans for the
// transposed operand. One f32 64x128 tile is 33 KiB, so f32 B4 (and f32 B3
// at D=160) streams 32-row tiles to fit both ring stages next to its
// resident tiles (at D=128, f32 B4 takes 218 KiB with the lo halves of k
// and v, f32 B3 216 KiB); the others stream 64 rows. One block per SM.
// Whole tiles, which every
// (query, key) pair of the block sees, skip the mask.
//
// Both designs: B3 has one block per (batch row, q head, q tile), heaviest
// causal tiles first; the key tiles run from the window bound to the causal
// bound (fully masked tiles are never loaded, the TPU kernel's pl.when
// skip). B4 has one block per (batch row, kv head, key tile). It walks its
// GQA group's q heads and, for each, the q tiles that can see its keys, as
// one sequence of ring steps, with dk and dv in registers throughout: the
// group sum of the TPU wrapper (:334-335) happens in a fixed order, with
// no atomics and no partials in device memory, so two runs give the same
// bits. B3 uses no atomics either. Where that grid underfills the SMs
// (B x Hkv x key tiles < the SM count: short sequences, small batches),
// f32 B4 instead launches clusters of c blocks along x, c the largest
// divisor of the group size G at most 8 whose c-fold grid stays within
// four waves of the SMs (dkv_cluster; 1: no split): rank r takes the
// key tile's q heads r G/c .. (r+1) G/c - 1 in the same order, and the c
// partial dK and dV are summed in rank order through distributed shared
// memory in the same launch, each rank summing and storing a slice of the
// rows. That sum is fixed by the sizes and the SM count, so two runs still
// give the same bits; it is another order than the unsplit walk's (ROADMAP
// C). No atomics, no partials in device memory; a cluster that cannot be
// resident raises.
//
// Both take any Sq/Sk (the TPU backward silently drops tail rows when its
// blocks do not tile the sequence). Layouts: q, dO (B, Sq, Hq, D); k, v
// (B, Sk, Hkv, D); dq like q; dk, dv like k; all contiguous, 16-byte
// aligned (TMA's bases 16 bytes). q head h reads
// kv head h / (Hq / Hkv). Both need more than 48 KB of shared memory
// (smem_opt_in.cuh). Registers, spills and the HGMMA, UTMALDG, HMMA and
// LDGSTS counts per instance are read by chip_smoke.py phase 1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

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
using attn::MAX_CLUSTER;
using attn::release;
using attn::Ring;
using attn::scores;
using attn::store_tile;
using attn::visible;
using bf16 = __nv_bfloat16;
using mma::add_into;
using mma::split4;
using mma::store_pair;

constexpr int THREADS = 256;  // 8 warps: 4 groups of 16 resident rows x 2 halves
constexpr int WARPS = THREADS / 32;
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

// Shared-memory layout, in elements of T, after up to 128 bytes that align
// the base (TMA's destinations): tiles of rows of D + PAD, the p / ds tiles
// ROWS x (NS + 8), then the ring's control (Ring).
template <typename T, int D, int NS_>
struct Layout {
  static constexpr int NS = NS_;
  static constexpr int LD = D + Tile<T>::PAD;
  static constexpr int LDP = NS + 8;
  static constexpr size_t resident = size_t(ROWS) * LD;
  static constexpr size_t stage = 2 * size_t(NS) * LD;  // two streamed tiles
  static constexpr size_t pds = size_t(ROWS) * LDP;
  static constexpr uint32_t resident_bytes = uint32_t(resident * sizeof(T));
  static constexpr uint32_t stream_bytes = uint32_t(NS * LD * sizeof(T));  // one streamed tile
  // B3: q, dO; ring of (k, v); ds
  static constexpr size_t dq_tiles = (2 * resident + 2 * stage + pds) * sizeof(T);
  // B4: k, v; ring of (q, dO); p^T, ds^T; f32 at D128 (PRE), the lo
  // halves of k and v (k and v themselves then hold their hi halves): B4
  // at S4096 6.11 ms with it, 6.67 without (an H100 80GB HBM3 at 700 W,
  // PERF.md). Not at D64, where the extra 34 KiB leave one block an SM
  // instead of two (whisper's S1500 ran 3% slower), nor at D160, where it
  // does not fit.
  static constexpr bool PRE = std::is_same<T, float>::value && D == 128;
  static constexpr size_t dkv_tiles =
      (2 * resident + 2 * stage + 2 * pds + (PRE ? 2 * resident : 0)) * sizeof(T);
  static constexpr size_t dq_bytes = 128 + dq_tiles + attn::ring_ctl_bytes(2);
  static constexpr size_t dkv_bytes = 128 + dkv_tiles + attn::ring_ctl_bytes(2);
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
attn_dq_kernel(const __grid_constant__ Maps maps, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int Hq,
               int Hkv, int causal, int window, float scale) {
  using L = Layout<T, D, Tile<T>::template NS_DQ<D>>;
  constexpr int NS = L::NS, LD = L::LD, LDP = L::LDP;
  constexpr int NT = NS / 16;  // 8-column tiles of a warp's half of the scores
  constexpr int ND = D / 16;   // 8-column tiles of a warp's half of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = aligned128(smem_raw);
  T* Qs = reinterpret_cast<T*>(base);  // ROWS x LD
  T* dOs = Qs + L::resident;           // ROWS x LD
  T* ring = dOs + L::resident;         // stage s: k at ring + s * stage, v after it
  T* dSs = ring + 2 * L::stage;        // ROWS x LDP
  const Ring rc = init_ring<2>(base + L::dq_tiles);

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

  // step `step`'s k and v tiles into its stage (one thread)
  auto issue = [&](int step) {
    const int s = step & 1, k0 = (t_begin + step) * NS;
    const uint32_t st = mma::smem_addr(ring + s * L::stage);
    wg::mbar_arrive_expect(rc.full(s), 2 * L::stream_bytes);
    wg::tma_load_4d(st, &maps.k, rc.full(s), 0, hk, k0, b);
    wg::tma_load_4d(st + L::stream_bytes, &maps.v, rc.full(s), 0, hk, k0, b);
  };
  if (tid == 0 && steps > 0) {
    wg::mbar_arrive_expect(rc.bar, 2 * L::resident_bytes);
    wg::tma_load_4d(mma::smem_addr(Qs), &maps.q, rc.bar, 0, h, q0, b);
    wg::tma_load_4d(mma::smem_addr(dOs), &maps.dout, rc.bar, 0, h, q0, b);
    issue(0);
    if (steps > 1) issue(1);
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
  if (steps > 0) wg::mbar_wait(rc.bar, 0);
  for (int step = 0; step < steps; ++step) {
    wg::mbar_wait(rc.full(step & 1), (step >> 1) & 1);  // this step's tiles are in
    const int k0 = (t_begin + step) * NS;
    const T* Kt = ring + (step & 1) * L::stage;
    const T* Vt = Kt + NS * LD;

    float s[NT][4], dp[NT][4];
    scores<D, LD, NT, false>(s, Qs + rg * 16 * LD, nullptr, Kt + half * (NS / 2) * LD, lane);
    scores<D, LD, NT, false>(dp, dOs + rg * 16 * LD, nullptr, Vt + half * (NS / 2) * LD, lane);
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
    // the warp pair of these 16 rows shares their ds: the other warp has
    // read the last step's before this one is written, and written its
    // half before either reads
    mma::named_sync(1 + rg, 64);
    store_tile<LDP>(dSs + rg * 16 * LDP + half * (NS / 2), dp, lane);
    mma::named_sync(1 + rg, 64);
    warp_ab<NS, LDP, LD>(acc, dSs + rg * 16 * LDP, Kt + half * (D / 2), lane);
    __syncwarp();  // the warp is done with the stage
    if (lane == 0 && release<WARPS>(rc, step & 1) && step + 2 < steps) {
      mma::fence_proxy_async();
      issue(step + 2);
    }
  }

  store_rows<D>(dq + (size_t(b) * Sq * Hq + h) * D, acc, scale, q0 + rg * 16, half * (D / 2), Sq,
                Hq, lane);
}

// B4. CLUSTER: the block is rank r of a cluster of c along grid x that
// shares its key tile (blockIdx.x / c) and splits the GQA group: rank r
// walks q heads r G / c .. (r + 1) G / c - 1, and the c partial dK and dV
// are summed in rank order through distributed shared memory, each rank
// summing and storing a slice of the 64 rows.
template <typename T, int D, bool CLUSTER>
__global__ void __launch_bounds__(THREADS)
attn_dkv_kernel(const __grid_constant__ Maps maps, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq,
                int Sk, int Hq, int Hkv, int causal, int window, float scale) {
  using L = Layout<T, D, Tile<T>::NS_DKV>;
  constexpr int NS = L::NS, LD = L::LD, LDP = L::LDP;
  constexpr int NT = NS / 16;  // 8-column tiles of a warp's half of the scores
  constexpr int ND = D / 16;   // 8-column tiles of a warp's half of dk, dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = aligned128(smem_raw);
  T* Ks = reinterpret_cast<T*>(base);  // ROWS x LD
  T* Vs = Ks + L::resident;            // ROWS x LD
  T* ring = Vs + L::resident;          // stage s: q at ring + s * stage, dO after it
  T* Ps = ring + 2 * L::stage;         // p^T, ROWS x LDP
  T* dSs = Ps + L::pds;                // ds^T, ROWS x LDP
  T* Klo = dSs + L::pds;               // PRE: lo of k, then of v, ROWS x LD each
  T* Vlo = Klo + L::resident;
  constexpr bool PRE = L::PRE;
  const Ring rc = init_ring<2>(base + L::dkv_tiles);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp >> 1, half = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int ranks = CLUSTER ? int(cooperative_groups::this_cluster().num_blocks()) : 1;
  const int rank = CLUSTER ? int(cooperative_groups::this_cluster().block_rank()) : 0;
  const int kt = blockIdx.x / ranks;  // causal: low key tiles see the most queries, run first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int heads = Hq / Hkv / ranks;  // the rank's share of the group
  const int h_first = hk * (Hq / Hkv) + rank * heads;
  const int k0 = kt * ROWS;

  // queries that can see keys k0 .. k0+ROWS-1: from k0 if causal, and below
  // k0 + ROWS - 1 + window for a causal window
  const int q_begin = causal ? k0 : 0;
  const int q_end = (causal && window > 0) ? min(Sq, k0 + ROWS - 1 + window) : Sq;
  const int t_begin = q_begin / NS;
  const int per_head = q_end > q_begin ? (q_end + NS - 1) / NS - t_begin : 0;
  const int steps = heads * per_head;  // (q head, q tile) pairs, head-major

  // step `step`'s q and dO tiles into its stage (one thread)
  auto issue = [&](int step) {
    const int s = step & 1;
    const int h = h_first + step / per_head;
    const int q0 = (t_begin + step % per_head) * NS;
    const uint32_t st = mma::smem_addr(ring + s * L::stage);
    wg::mbar_arrive_expect(rc.full(s), 2 * L::stream_bytes);
    wg::tma_load_4d(st, &maps.q, rc.full(s), 0, h, q0, b);
    wg::tma_load_4d(st + L::stream_bytes, &maps.dout, rc.full(s), 0, h, q0, b);
  };
  if (tid == 0 && steps > 0) {
    wg::mbar_arrive_expect(rc.bar, 2 * L::resident_bytes);
    wg::tma_load_4d(mma::smem_addr(Ks), &maps.k, rc.bar, 0, hk, k0, b);
    wg::tma_load_4d(mma::smem_addr(Vs), &maps.v, rc.bar, 0, hk, k0, b);
    issue(0);
    if (steps > 1) issue(1);
  }

  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  float dk_acc[ND][4] = {}, dv_acc[ND][4] = {};
  if (steps > 0) {
    wg::mbar_wait(rc.bar, 0);
    if constexpr (PRE) {  // k and v (rows of k, then of v) into tf32 hi and lo, once
      attn::split_rows<D, LD, THREADS>(Ks, Klo, 2 * ROWS);
      __syncthreads();
    }
  }
  for (int step = 0; step < steps; ++step) {
    const int h = h_first + step / per_head;
    const int q0 = (t_begin + step % per_head) * NS;
    // lse and delta of the thread's score columns c = half NS / 2 + 8i +
    // 2t + j (0 past Sq), read while the products run
    float lse_c[NT][2], delta_c[NT][2];
    const size_t row = (size_t(b) * Hq + h) * Sq;
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qp = q0 + half * (NS / 2) + 8 * i + 2 * t + j;
        lse_c[i][j] = qp < Sq ? lse[row + qp] : 0.f;
        delta_c[i][j] = qp < Sq ? delta[row + qp] : 0.f;
      }
    wg::mbar_wait(rc.full(step & 1), (step >> 1) & 1);  // this step's tiles are in
    const T* Qt = ring + (step & 1) * L::stage;
    const T* dOt = Qt + NS * LD;

    // transposed scores: the warp's 16 keys x its half of the NS queries
    float s[NT][4], dp[NT][4];
    scores<D, LD, NT, PRE>(s, Ks + rg * 16 * LD, Klo + rg * 16 * LD, Qt + half * (NS / 2) * LD,
                           lane);
    scores<D, LD, NT, PRE>(dp, Vs + rg * 16 * LD, Vlo + rg * 16 * LD, dOt + half * (NS / 2) * LD,
                           lane);
    auto grad_scores = [&](auto whole) {  // p in s, ds = p (dp - delta) in dp
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + rg * 16 + g + 8 * (e >> 1);
          const int qp = q0 + half * (NS / 2) + 8 * i + 2 * t + (e & 1);
          const float p =
              (decltype(whole)::value || (qp < Sq && visible(qp, kp, Sk, causal, window)))
                  ? exp2f(fmaf(s[i][e], scale2, -lse_c[i][e & 1] * kLog2e))
                  : 0.f;
          s[i][e] = p;
          dp[i][e] = p * (dp[i][e] - delta_c[i][e & 1]);
        }
    };
    // a q tile that sees every key of the block skips the mask
    if (q0 + NS <= Sq && k0 + ROWS <= Sk && (!causal || q0 >= k0 + ROWS - 1) &&
        (window <= 0 || q0 + NS - 1 - k0 < window))
      grad_scores(std::true_type{});
    else
      grad_scores(std::false_type{});
    // the warp pair of these 16 keys shares their p^T and ds^T (as B3)
    mma::named_sync(1 + rg, 64);
    store_tile<LDP>(Ps + rg * 16 * LDP + half * (NS / 2), s, lane);
    store_tile<LDP>(dSs + rg * 16 * LDP + half * (NS / 2), dp, lane);
    mma::named_sync(1 + rg, 64);
    warp_ab<NS, LDP, LD>(dv_acc, Ps + rg * 16 * LDP, dOt + half * (D / 2), lane);
    warp_ab<NS, LDP, LD>(dk_acc, dSs + rg * 16 * LDP, Qt + half * (D / 2), lane);
    __syncwarp();  // the warp is done with the stage
    if (lane == 0 && release<WARPS>(rc, step & 1) && step + 2 < steps) {
      mma::fence_proxy_async();
      issue(step + 2);
    }
  }

  const size_t head = (size_t(b) * Sk * Hkv + hk) * D;
  if constexpr (CLUSTER) {
    static_assert(std::is_same<T, float>::value, "B4 splits its group in f32 only");
    // the partials, rows of stride LD over the resident k and v tiles
    // (every warp has read them): dK, then dV
    auto cluster = cooperative_groups::this_cluster();
    float* part = reinterpret_cast<float*>(base);
    __syncthreads();
    store_tile<LD>(part + rg * 16 * LD + half * (D / 2), dk_acc, lane);
    store_tile<LD>(part + L::resident + rg * 16 * LD + half * (D / 2), dv_acc, lane);
    cluster.sync();
    // rank r sums and stores pairs [r per, (r + 1) per) of the 64 x D/2,
    // all ranks' partials loaded first (one latency of distributed shared
    // memory), then summed in rank order
    const float* parts[MAX_CLUSTER];
#pragma unroll
    for (int rr = 0; rr < MAX_CLUSTER; ++rr)
      parts[rr] = rr < ranks ? cluster.map_shared_rank(part, rr) : part;
    constexpr int PAIRS = ROWS * D / 2;
    const int per = (PAIRS + ranks - 1) / ranks;
    for (int i = rank * per + tid; i < min(PAIRS, (rank + 1) * per); i += THREADS) {
      const int r = i / (D / 2), col = 2 * (i % (D / 2));
      if (k0 + r >= Sk) continue;
      const int at = r * LD + col;
      float2 x[MAX_CLUSTER], y[MAX_CLUSTER];
#pragma unroll
      for (int rr = 0; rr < MAX_CLUSTER; ++rr)
        if (rr < ranks) {
          x[rr] = *reinterpret_cast<const float2*>(parts[rr] + at);
          y[rr] = *reinterpret_cast<const float2*>(parts[rr] + L::resident + at);
        }
      float2 a = x[0], c = y[0];
#pragma unroll
      for (int rr = 1; rr < MAX_CLUSTER; ++rr)
        if (rr < ranks) a.x += x[rr].x, a.y += x[rr].y, c.x += y[rr].x, c.y += y[rr].y;
      const size_t out = head + size_t(k0 + r) * Hkv * D + col;
      store_pair(dk + out, a.x * scale, a.y * scale);
      store_pair(dv + out, c.x, c.y);
    }
    cluster.sync();  // no block leaves while another reads its shared memory
  } else {
    store_rows<D>(dk + head, dk_acc, scale, k0 + rg * 16, half * (D / 2), Sk, Hkv, lane);
    store_rows<D>(dv + head, dv_acc, 1.f, k0 + rg * 16, half * (D / 2), Sk, Hkv, lane);
  }
}

// ------------------------------------------- bf16 at D 64/128: wgmma fed by TMA
//
// Every product is a warpgroup wgmma (wgmma.cuh) whose shared-memory
// operands are 128-byte-swizzled tiles written by TMA, and no tile is
// transposed in shared memory: the first products (scores and dP) take both
// operands K-major, as the forward's Q K^T; the second take A (the packed
// p or ds fragments) from registers and B MN-major through the transpose
// bit, as the forward's P V. B3 reads its K tile both ways (K-major for
// S = Q K^T, MN-major for dQ += dS K). B4 computes the transposed scores
// directly, S^T = K Q^T and dP^T = V dO^T with the keys as the M dimension,
// so p^T and ds^T land in registers as A fragments of dV += P^T dO and
// dK += dS^T Q, which read dO and Q MN-major from the tiles the first
// products read K-major.

// Barriers of a block (wgmma kernels): [0] the resident tiles' full; per
// stage s, two full barriers (B3: K, V; B4: Q, dO with the lse and delta
// rows) and an empty one, released by lane 0 of every consumer warp.
__device__ __forceinline__ uint32_t bar_first(uint32_t bar, int s) {
  return bar + 8 * (1 + s);
}
template <int ST>
__device__ __forceinline__ uint32_t bar_second(uint32_t bar, int s) {
  return bar + 8 * (1 + ST + s);
}
template <int ST>
__device__ __forceinline__ uint32_t bar_empty(uint32_t bar, int s) {
  return bar + 8 * (1 + 2 * ST + s);
}

// The block's shared memory past the alignment of its base to 1024 bytes
// (the swizzle's atom), as a 32-bit shared address.
__device__ __forceinline__ uint32_t aligned_base(const unsigned char* smem_raw) {
  const uint32_t raw = mma::smem_addr(smem_raw);
  return raw + (1024 - raw % 1024) % 1024;
}

__device__ __forceinline__ void init_bars(unsigned char* smem_raw, uint32_t bar, int nbar,
                                          int stages, int second_count, int consumers) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + (bar - mma::smem_addr(smem_raw)));
  for (int i = 0; i < nbar; ++i)
    mma::mbar_init(bars + i, i < 1 + stages ? 1 : i < 1 + 2 * stages ? second_count : 4 * consumers);
  mma::mbar_fence_init();
}

// Writes a warpgroup's accumulators (its warp's 16 rows from r0, the
// m64n64 fragments of D / 64 column chunks) times f into rows of a (B, S,
// H, D) head (dst at its row 0); rows past S are not stored.
template <int D>
__device__ __forceinline__ void store_wg_rows(bf16* dst, const float (&c)[D / 64][32], float f,
                                              int r0, int S, int H, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row_i = r0 + g + 8 * r;
    if (row_i >= S) continue;
    bf16* row = dst + size_t(row_i) * H * D + 2 * t;
#pragma unroll
    for (int cc = 0; cc < D / 64; ++cc)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma::store_pair(row + 64 * cc + 8 * j, c[cc][4 * j + 2 * r] * f,
                        c[cc][4 * j + 2 * r + 1] * f);
  }
}

// A score tile's fragments (m64n8N: 8-column tiles j) as bf16 A fragments
// of the second products, k step j = columns 16j .. 16j + 15 (tiles 2j
// and 2j + 1), rounded once to bf16.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = mma::pack_bf16(x[8 * j + 2 * e], x[8 * j + 2 * e + 1]);
}

// B3's tiles: NC consumer warpgroups of 64 q rows each (BQ = 64 NC), then
// the producer; key tiles of BK rows in a ring of STAGES. Shared memory,
// after up to 1024 bytes that align the base: Q and dO (D / 64 swizzled
// tiles of BQ x 64 each), per stage K and V (D / 64 tiles of BK x 64 each),
// then the 1 + 3 STAGES mbarriers. With two consumer warpgroups the
// producer is a warpgroup whose registers setmaxnreg moves to the
// consumers (ptxas gives 384 threads 168 a thread); with one, a warp.
template <int D, int NC>
struct DqLayout {
  static constexpr int BQ = 64 * NC;
  static constexpr int BK = 64;
  static constexpr int STAGES = 2;
  static constexpr int THREADS = NC == 2 ? 384 : 160;
  static constexpr uint32_t q = uint32_t(BQ) * D * 2;   // Q or dO
  static constexpr uint32_t kv = uint32_t(BK) * D * 2;  // K or V of one stage
  static constexpr uint32_t ring = 2 * q;
  static constexpr uint32_t bars = ring + STAGES * 2 * kv;
  static constexpr int NBAR = 1 + 3 * STAGES;
  static constexpr size_t bytes = 1024 + bars + 8 * NBAR;
};

// What B3's producer and consumers share.
struct DqBlock {
  uint32_t qs, dos, ring, bar;
  int q0, t_begin, steps, h, b;
};

// B3's producer thread: Q and dO once, then K and V of each key tile into
// its stage once every consumer warp has released it.
template <int D, int NC>
__device__ __forceinline__ void dq_produce(const DqBlock& blk, const CUtensorMap* tq,
                                           const CUtensorMap* tdo, const CUtensorMap* tk,
                                           const CUtensorMap* tv, int hk) {
  using L = DqLayout<D, NC>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::STAGES;
  wg::mbar_arrive_expect(blk.bar, 2 * L::q);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    wg::tma_load_4d(blk.qs + c * BQ * 128, tq, blk.bar, 64 * c, blk.h, blk.q0, blk.b);
    wg::tma_load_4d(blk.dos + c * BQ * 128, tdo, blk.bar, 64 * c, blk.h, blk.q0, blk.b);
  }
  for (int i = 0; i < blk.steps; ++i) {
    const int s = i % ST;
    if (i >= ST) wg::mbar_wait(bar_empty<ST>(blk.bar, s), ((i / ST) - 1) & 1);
    const int k0 = (blk.t_begin + i) * BK;
    const uint32_t ks = blk.ring + 2 * s * L::kv, vs = ks + L::kv;
    wg::mbar_arrive_expect(bar_first(blk.bar, s), L::kv);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      wg::tma_load_4d(ks + c * BK * 128, tk, bar_first(blk.bar, s), 64 * c, hk, k0, blk.b);
    wg::mbar_arrive_expect(bar_second<ST>(blk.bar, s), L::kv);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      wg::tma_load_4d(vs + c * BK * 128, tv, bar_second<ST>(blk.bar, s), 64 * c, hk, k0, blk.b);
  }
}

// B3's consumer warpgroup w: q rows q0 + 64 w .. q0 + 64 w + 63 over every
// key tile of the block, then its dq rows. Per key tile: S = Q K^T and dP =
// dO V^T (SS, K-major), p = exp(s scale - lse) on S's fragments while dP is
// in flight, ds = p (dp - delta) rounded once to bf16 and packed as A, then
// dQ += dS K per 64 columns of D (RS, K MN-major) into the accumulators.
template <int D, int NC>
__device__ __forceinline__ void dq_consume(const DqBlock& blk, int w, const float* __restrict__ lse,
                                           const float* __restrict__ delta, bf16* __restrict__ dq,
                                           int Sq, int Sk, int Hq, int causal, int window,
                                           float scale) {
  using L = DqLayout<D, NC>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::STAGES;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rw = blk.q0 + 64 * w + 16 * warp;  // the warp's first row
  const uint32_t q_desc = wg::desc_lo(blk.qs + w * 64 * 128, 16);
  const uint32_t do_desc = wg::desc_lo(blk.dos + w * 64 * 128, 16);

  // rows g and g + 8 of the warp's 16: lse in log2 units, delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = rw + g + 8 * r;
    const size_t row = (size_t(blk.b) * Hq + blk.h) * Sq + qp;
    lse2[r] = qp < Sq ? lse[row] * kLog2e : 0.f;
    dlt[r] = qp < Sq ? delta[row] : 0.f;
  }
  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  float acc[D / 64][32];
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;

  if (blk.steps > 0) wg::mbar_wait(blk.bar, 0);
  for (int i = 0; i < blk.steps; ++i) {
    const int s = i % ST;
    const uint32_t phase = (i / ST) & 1;
    const int k0 = (blk.t_begin + i) * BK;
    const uint32_t ks = blk.ring + 2 * s * L::kv, vs = ks + L::kv;

    // S = Q K^T and dP = dO V^T: D / 16 k steps each, 32 bytes further
    // along the rows (the next 64 columns in the next swizzled tile)
    float sc[32], dp[32];
    const uint32_t k_desc = wg::desc_lo(ks, 16), v_desc = wg::desc_lo(vs, 16);
    wg::mbar_wait(bar_first(blk.bar, s), phase);
    wg::fence();
    wg::static_for<0, D / 16>([&](auto kk) {
      constexpr int K = decltype(kk)::value, c = K / 4, step = 2 * (K % 4);  // 16-byte units
      wg::mma_ss<c * BQ * 8 + step, c * BK * 8 + step, (K > 0)>(sc, q_desc, k_desc);
    });
    wg::commit();
    wg::mbar_wait(bar_second<ST>(blk.bar, s), phase);
    wg::fence();
    wg::static_for<0, D / 16>([&](auto kk) {
      constexpr int K = decltype(kk)::value, c = K / 4, step = 2 * (K % 4);
      wg::mma_ss<c * BQ * 8 + step, c * BK * 8 + step, (K > 0)>(dp, do_desc, v_desc);
    });
    wg::commit();

    wg::wait<1>();  // S is in; dP may still run
    wg::fence_operand(sc);
    auto probs = [&](auto whole) {  // p, in sc
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = rw + g + 8 * (e >> 1);
          const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
          sc[4 * j + e] = (decltype(whole)::value || visible(qp, kp, Sk, causal, window))
                              ? exp2f(fmaf(sc[4 * j + e], scale2, -lse2[e >> 1]))
                              : 0.f;
        }
    };
    // a key tile that every row of the warp sees skips the mask
    if (k0 + BK <= Sk && (!causal || k0 + BK - 1 <= rw) && (window <= 0 || rw + 15 - k0 < window))
      probs(std::true_type{});
    else
      probs(std::false_type{});
    wg::wait<0>();
    wg::fence_operand(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] *= dp[e] - dlt[(e >> 1) & 1];  // ds
    uint32_t ds[BK / 16][4];
    pack_a<BK>(ds, sc);

    // dQ += dS K per 64 columns of D: K's tile read MN-major (k16 step j
    // starts 16 rows, 2048 bytes, further)
    const uint32_t kt_desc = wg::desc_lo(ks, BK * 128);
    wg::fence();
    wg::static_for<0, D / 64>([&](auto cc) {
      constexpr int c = decltype(cc)::value;
      wg::static_for<0, BK / 16>([&](auto jj) {
        constexpr int j = decltype(jj)::value;
        wg::mma_rs<c * BK * 8 + j * 128, 1>(acc[c], ds[j], kt_desc);
      });
    });
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int c = 0; c < D / 64; ++c) wg::fence_operand(acc[c]);
    if (lane == 0) wg::mbar_arrive(bar_empty<ST>(blk.bar, s));  // this warp is done with the stage
  }
  store_wg_rows<D>(dq + (size_t(blk.b) * Sq * Hq + blk.h) * D, acc, scale, rw, Sq, Hq, lane);
}

template <int D, int NC>
__global__ void __launch_bounds__(DqLayout<D, NC>::THREADS, 1)
attn_dq_kernel_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int causal, int window,
                     float scale) {
  using L = DqLayout<D, NC>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqBlock blk;
  blk.qs = aligned_base(smem_raw);
  blk.dos = blk.qs + L::q;
  blk.ring = blk.qs + L::ring;
  blk.bar = blk.qs + L::bars;
  blk.h = blockIdx.y;
  blk.b = blockIdx.z;
  blk.q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  // key tiles from the window bound to the causal bound: fully masked
  // tiles are never loaded (the TPU kernel's pl.when skip)
  const int k_end = causal ? min(Sk, blk.q0 + BQ) : Sk;
  const int k_begin = (causal && window > 0) ? max(0, blk.q0 - window + 1) : 0;
  blk.t_begin = k_begin / BK;
  blk.steps = k_end > k_begin ? (k_end + BK - 1) / BK - blk.t_begin : 0;

  if (threadIdx.x == 0) init_bars(smem_raw, blk.bar, L::NBAR, ST, 1, NC);
  __syncthreads();

  // the thread's warpgroup, read from lane 0 so that the compiler sees it
  // uniform across each warp: consumers 0 .. NC - 1, then the producer
  const int role = __shfl_sync(0xffffffffu, int(threadIdx.x) >> 7, 0);
  if (role == NC) {
    if constexpr (NC == 2) wg::regs_dec<24>();
    if (threadIdx.x == 128 * NC && blk.steps > 0)
      dq_produce<D, NC>(blk, &tq, &tdo, &tk, &tv, blk.h / (Hq / Hkv));
  } else {
    if constexpr (NC == 2) wg::regs_inc<240>();
    dq_consume<D, NC>(blk, role, lse, delta, dq, Sq, Sk, Hq, causal, window, scale);
  }
}

// B4's tiles: NC consumer warpgroups of 64 key rows each (BKR = 64 NC
// resident keys: K and V), then the producer; q tiles of BN rows (Q, dO
// and their lse and delta rows) in a ring of STAGES. Shared memory, after
// up to 1024 bytes that align the base: K and V (D / 64 swizzled tiles of
// BKR x 64 each), per stage Q and dO (D / 64 tiles of BN x 64 each), per
// stage the lse (log2 units) and delta rows (BN floats each), then the 1 +
// 3 STAGES mbarriers. Producer as B3's. At D128 a consumer holds dK and dV
// (128 registers) beside S^T and dP^T (64): 220 registers with one consumer
// warpgroup, so D128 runs NC = 1 only (dkv_groups). With two, ptxas holds
// every thread to 168 (it allocates by whole warpgroups, whatever
// setmaxnreg asks: 872 bytes spilled, and 272 with 32-query steps), and a
// producer warp does not help: 288 threads are allocated as 384, so
// __maxnreg__(224) built without spills but could not launch. Blocks of
// one warpgroup that feeds itself, two an SM, ran 16% slower at S4096 and
// 50% at whisper's S1500 (PERF.md).
template <int D, int NC>
struct DkvLayout {
  static constexpr int BKR = 64 * NC;
  static constexpr int BN = 64;
  static constexpr int STAGES = 2;
  static constexpr int THREADS = NC == 2 ? 384 : 160;
  static constexpr uint32_t kv = uint32_t(BKR) * D * 2;  // K or V
  static constexpr uint32_t qt = uint32_t(BN) * D * 2;   // Q or dO of one stage
  static constexpr uint32_t ring = 2 * kv;
  static constexpr uint32_t rows = ring + STAGES * 2 * qt;
  static constexpr uint32_t bars = rows + STAGES * 2 * BN * 4;
  static constexpr int NBAR = 1 + 3 * STAGES;
  static constexpr size_t bytes = 1024 + bars + 8 * NBAR;
};

// What B4's producer and consumers share. Step i is q head hk group + i /
// per_head and q tile t_begin + i % per_head: the GQA group's heads
// head-major, each over the q tiles that can see the block's keys.
struct DkvBlock {
  uint32_t ks, vs, ring, bar;
  float* rows;  // the ring's lse and delta rows (generic address)
  int k0, t_begin, per_head, steps, hk, group, b;
};

// B4's producer warp: K and V once; then per step, once every consumer warp
// has released the stage, lane 0 starts the Q and dO loads and all 32
// lanes copy the step's lse (times log2(e)) and delta rows with ordinary
// loads (a tensor map needs 16-byte strides, which (B, Hq, Sq) f32 rows of
// a ragged Sq do not have) and arrive on the dO barrier.
template <int D, int NC>
__device__ __forceinline__ void dkv_produce(const DkvBlock& blk, const CUtensorMap* tk,
                                            const CUtensorMap* tv, const CUtensorMap* tq,
                                            const CUtensorMap* tdo, const float* __restrict__ lse,
                                            const float* __restrict__ delta, int Sq, int Hq,
                                            int lane) {
  using L = DkvLayout<D, NC>;
  constexpr int BKR = L::BKR, BN = L::BN, ST = L::STAGES;
  if (lane == 0) {
    wg::mbar_arrive_expect(blk.bar, 2 * L::kv);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      wg::tma_load_4d(blk.ks + c * BKR * 128, tk, blk.bar, 64 * c, blk.hk, blk.k0, blk.b);
      wg::tma_load_4d(blk.vs + c * BKR * 128, tv, blk.bar, 64 * c, blk.hk, blk.k0, blk.b);
    }
  }
  for (int i = 0; i < blk.steps; ++i) {
    const int s = i % ST;
    if (i >= ST) wg::mbar_wait(bar_empty<ST>(blk.bar, s), ((i / ST) - 1) & 1);
    const int h = blk.hk * blk.group + i / blk.per_head;
    const int q0 = (blk.t_begin + i % blk.per_head) * BN;
    const uint32_t qs = blk.ring + 2 * s * L::qt, dos = qs + L::qt;
    if (lane == 0) {
      wg::mbar_arrive_expect(bar_first(blk.bar, s), L::qt);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        wg::tma_load_4d(qs + c * BN * 128, tq, bar_first(blk.bar, s), 64 * c, h, q0, blk.b);
      wg::mbar_expect(bar_second<ST>(blk.bar, s), L::qt);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        wg::tma_load_4d(dos + c * BN * 128, tdo, bar_second<ST>(blk.bar, s), 64 * c, h, q0, blk.b);
    }
    float* rows = blk.rows + s * 2 * BN;
    const size_t base = (size_t(blk.b) * Hq + h) * Sq;
#pragma unroll
    for (int r = lane; r < BN; r += 32) {
      const int qp = q0 + r;
      rows[r] = qp < Sq ? lse[base + qp] * kLog2e : 0.f;
      rows[BN + r] = qp < Sq ? delta[base + qp] : 0.f;
    }
    wg::mbar_arrive(bar_second<ST>(blk.bar, s));  // this lane's rows are written
  }
}

// B4's consumer warpgroup w: keys k0 + 64 w .. k0 + 64 w + 63 over every
// step of the block, then its dk and dv rows. Per step: S^T = K Q^T and
// dP^T = V dO^T (SS, K-major), p^T = exp(s^T scale - lse) on S^T's
// fragments while dP^T is in flight (lse and delta vary along the
// columns), ds^T = p^T (dp^T - delta), both rounded once to bf16 and packed
// as A, then dV += P^T dO and dK += dS^T Q per 64 columns of D (RS, dO and
// Q MN-major) into the accumulators: the group sum stays in registers, in
// step order, and no key is shared with another warpgroup.
template <int D, int NC>
__device__ __forceinline__ void dkv_consume(const DkvBlock& blk, int w, bf16* __restrict__ dk,
                                            bf16* __restrict__ dv, int Sq, int Sk, int Hkv,
                                            int causal, int window, float scale) {
  using L = DkvLayout<D, NC>;
  constexpr int BKR = L::BKR, BN = L::BN, ST = L::STAGES;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw = blk.k0 + 64 * w + 16 * warp;  // the warp's first key
  const uint32_t k_desc = wg::desc_lo(blk.ks + w * 64 * 128, 16);
  const uint32_t v_desc = wg::desc_lo(blk.vs + w * 64 * 128, 16);
  const float scale2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  float dk_acc[D / 64][32], dv_acc[D / 64][32];
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;

  if (blk.steps > 0) wg::mbar_wait(blk.bar, 0);
  for (int i = 0; i < blk.steps; ++i) {
    const int s = i % ST;
    const uint32_t phase = (i / ST) & 1;
    const int q0 = (blk.t_begin + i % blk.per_head) * BN;
    const uint32_t qs = blk.ring + 2 * s * L::qt, dos = qs + L::qt;

    float st[BN / 2], dpt[BN / 2];
    const uint32_t q_desc = wg::desc_lo(qs, 16), do_desc = wg::desc_lo(dos, 16);
    wg::mbar_wait(bar_first(blk.bar, s), phase);
    wg::fence();
    wg::static_for<0, D / 16>([&](auto kk) {
      constexpr int K = decltype(kk)::value, c = K / 4, step = 2 * (K % 4);  // 16-byte units
      wg::mma_ss<c * BKR * 8 + step, c * BN * 8 + step, (K > 0)>(st, k_desc, q_desc);
    });
    wg::commit();
    wg::mbar_wait(bar_second<ST>(blk.bar, s), phase);  // dO, and the lse and delta rows
    wg::fence();
    wg::static_for<0, D / 16>([&](auto kk) {
      constexpr int K = decltype(kk)::value, c = K / 4, step = 2 * (K % 4);
      wg::mma_ss<c * BKR * 8 + step, c * BN * 8 + step, (K > 0)>(dpt, v_desc, do_desc);
    });
    wg::commit();
    const float* lse2 = blk.rows + s * 2 * BN;
    const float* dlt = lse2 + BN;

    wg::wait<1>();  // S^T is in; dP^T may still run
    wg::fence_operand(st);
    auto probs = [&](auto whole) {  // p^T, in st; column c is query q0 + c
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t4 + (e & 1);
          const int qp = q0 + c;
          const int kp = kw + g + 8 * (e >> 1);
          st[4 * j + e] =
              (decltype(whole)::value || (qp < Sq && visible(qp, kp, Sk, causal, window)))
                  ? exp2f(fmaf(st[4 * j + e], scale2, -lse2[c]))
                  : 0.f;
        }
    };
    // a q tile that sees every key of the warp skips the mask
    if (q0 + BN <= Sq && kw + 16 <= Sk && (!causal || q0 >= kw + 15) &&
        (window <= 0 || q0 + BN - 1 - kw < window))
      probs(std::true_type{});
    else
      probs(std::false_type{});
    wg::wait<0>();
    wg::fence_operand(dpt);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dlt[8 * j + 2 * t4 + (e & 1)]);  // ds^T
    uint32_t pa[BN / 16][4], da[BN / 16][4];
    pack_a<BN>(pa, st);
    pack_a<BN>(da, dpt);

    // dV += P^T dO and dK += dS^T Q per 64 columns of D: dO's and Q's tiles
    // read MN-major (k16 step j starts 16 rows, 2048 bytes, further)
    const uint32_t dot_desc = wg::desc_lo(dos, BN * 128), qt_desc = wg::desc_lo(qs, BN * 128);
    wg::fence();
    wg::static_for<0, D / 64>([&](auto cc) {
      constexpr int c = decltype(cc)::value;
      wg::static_for<0, BN / 16>([&](auto jj) {
        constexpr int j = decltype(jj)::value;
        wg::mma_rs<c * BN * 8 + j * 128, 1>(dv_acc[c], pa[j], dot_desc);
      });
    });
    wg::static_for<0, D / 64>([&](auto cc) {
      constexpr int c = decltype(cc)::value;
      wg::static_for<0, BN / 16>([&](auto jj) {
        constexpr int j = decltype(jj)::value;
        wg::mma_rs<c * BN * 8 + j * 128, 1>(dk_acc[c], da[j], qt_desc);
      });
    });
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      wg::fence_operand(dv_acc[c]);
      wg::fence_operand(dk_acc[c]);
    }
    if (lane == 0) wg::mbar_arrive(bar_empty<ST>(blk.bar, s));  // this warp is done with the stage
  }
  const size_t head = (size_t(blk.b) * Sk * Hkv + blk.hk) * D;
  store_wg_rows<D>(dk + head, dk_acc, scale, kw, Sk, Hkv, lane);
  store_wg_rows<D>(dv + head, dv_acc, 1.f, kw, Sk, Hkv, lane);
}

template <int D, int NC>
__global__ void __launch_bounds__(DkvLayout<D, NC>::THREADS, 1)
attn_dkv_kernel_wgmma(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv, int causal,
                      int window, float scale) {
  using L = DkvLayout<D, NC>;
  constexpr int BKR = L::BKR, BN = L::BN, ST = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvBlock blk;
  blk.ks = aligned_base(smem_raw);
  blk.vs = blk.ks + L::kv;
  blk.ring = blk.ks + L::ring;
  blk.rows = reinterpret_cast<float*>(smem_raw + (blk.ks + L::rows - mma::smem_addr(smem_raw)));
  blk.bar = blk.ks + L::bars;
  blk.hk = blockIdx.y;
  blk.b = blockIdx.z;
  blk.group = Hq / Hkv;
  blk.k0 = blockIdx.x * BKR;  // causal: low key tiles see the most queries, run first
  // queries that can see keys k0 .. k0 + BKR - 1: from k0 if causal, and
  // below k0 + BKR - 1 + window for a causal window
  const int q_begin = causal ? blk.k0 : 0;
  const int q_end = (causal && window > 0) ? min(Sq, blk.k0 + BKR - 1 + window) : Sq;
  blk.t_begin = q_begin / BN;
  blk.per_head = q_end > q_begin ? (q_end + BN - 1) / BN - blk.t_begin : 0;
  blk.steps = blk.group * blk.per_head;

  if (threadIdx.x == 0) init_bars(smem_raw, blk.bar, L::NBAR, ST, 32, NC);
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, int(threadIdx.x) >> 7, 0);
  if (role == NC) {
    if constexpr (NC == 2) wg::regs_dec<24>();
    if ((threadIdx.x >> 5) == 4 * NC && blk.steps > 0)
      dkv_produce<D, NC>(blk, &tk, &tv, &tq, &tdo, lse, delta, Sq, Hq, threadIdx.x & 31);
  } else {
    if constexpr (NC == 2) wg::regs_inc<240>();
    dkv_consume<D, NC>(blk, role, dk, dv, Sq, Sk, Hkv, causal, window, scale);
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

// B3: a block per (ROWS q rows, q head, row); B4: per (ROWS key rows, kv
// head, row), times its cluster along x.
dim3 dq_grid(int B, int Sq, int Hq) { return dim3((Sq + ROWS - 1) / ROWS, Hq, B); }
dim3 dkv_grid(int B, int Sk, int Hkv, int cluster = 1) {
  return dim3(cluster * ((Sk + ROWS - 1) / ROWS), Hkv, B);
}

// f32 B4's cluster: where its grid of (key tile, kv head, row) blocks
// underfills the SMs, the largest divisor c of the GQA group at most
// MAX_CLUSTER whose c-fold grid stays within SPLIT_WAVES waves of the SMs
// (1: no split); bf16 never splits. Each split block pays for its resident
// tiles and the cluster's sum: at 11b's S128 Hq40:8 (G 5) the split ran B4
// 0.110 -> 0.031 ms at B1 (80 blocks) and 0.110 -> 0.091 at B4 (320), but
// 0.115 -> 0.163 at B8 (640, 4.8 waves; an H100 80GB HBM3 at 700 W,
// PERF.md). A fixed function of the sizes and the SM count, so two
// launches sum in the same order.
constexpr int SPLIT_WAVES = 4;
int dkv_cluster(int B, int Sk, int Hkv, int group, bool f32) {
  const long blocks = long(B) * Hkv * ((Sk + ROWS - 1) / ROWS);
  const int sms = wg::sm_count();
  if (!f32 || blocks >= sms) return 1;
  for (int c = group < MAX_CLUSTER ? group : MAX_CLUSTER; c > 1; --c)
    if (group % c == 0 && blocks * c <= long(SPLIT_WAVES) * sms) return c;
  return 1;
}

template <typename T, int D>
constexpr size_t dq_smem() {
  return Layout<T, D, Tile<T>::template NS_DQ<D>>::dq_bytes;
}
template <typename T, int D>
constexpr size_t dkv_smem() {
  return Layout<T, D, Tile<T>::NS_DKV>::dkv_bytes;
}

// The mma.sync kernels' tensor maps: boxes of D + PAD columns, of ROWS
// rows for the resident operands and NS for the streamed ones (B3: q and
// dO resident; B4: k and v).
template <typename T, int D>
cudaError_t make_maps(Maps* m, const Args& a, bool dkv, int ns) {
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr int cols = D + Tile<T>::PAD;
  const int qrows = dkv ? ns : ROWS, krows = dkv ? ROWS : ns;
  cudaError_t err = wg::map_box(&m->q, a.q, f32, a.B, a.Sq, a.Hq, D, cols, qrows,
                                CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = wg::map_box(&m->dout, a.dout, f32, a.B, a.Sq, a.Hq, D, cols, qrows,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = wg::map_box(&m->k, a.k, f32, a.B, a.Sk, a.Hkv, D, cols, krows,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = wg::map_box(&m->v, a.v, f32, a.B, a.Sk, a.Hkv, D, cols, krows,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  return err;
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  using L = Layout<T, D, Tile<T>::template NS_DQ<D>>;
  constexpr size_t smem = L::dq_bytes;
  static_assert(smem <= kMaxSmem, "B3's tiles exceed the shared memory of a block");
  // no keys: dq is zeros, and there is nothing to map
  if (a.Sk <= 0)
    return cudaMemsetAsync(a.dq, 0, size_t(a.B) * a.Sq * a.Hq * D * sizeof(T), a.stream);
  Maps maps;
  cudaError_t err = make_maps<T, D>(&maps, a, false, L::NS);
  if (err != cudaSuccess) return err;
  static SmemOptIn opt_in;  // one per kernel instance
  err = opt_in_smem(opt_in, attn_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  attn_dq_kernel<T, D><<<dq_grid(a.B, a.Sq, a.Hq), THREADS, smem, a.stream>>>(
      maps, a.lse, a.delta, static_cast<T*>(a.dq), a.Sq, a.Sk, a.Hq, a.Hkv, a.causal, a.window,
      a.scale);
  return cudaGetLastError();
}

// f32 B4 as clusters of c blocks along x (dkv_cluster); a cluster that
// cannot be resident raises (attn::launch_clusters).
template <int D>
cudaError_t launch_dkv_cluster(const Args& a, const Maps& maps, int c) {
  constexpr size_t smem = dkv_smem<float, D>();
  auto kernel = attn_dkv_kernel<float, D, true>;
  static SmemOptIn opt_in;                    // one per kernel instance
  static std::atomic<unsigned> resident{0};  // bit c: clusters of c fit
  const cudaError_t err = opt_in_smem(opt_in, kernel, smem);
  if (err != cudaSuccess) return err;
  return attn::launch_clusters(kernel, resident, dkv_grid(a.B, a.Sk, a.Hkv, c), THREADS, smem,
                               a.stream, c, maps, a.lse, a.delta, static_cast<float*>(a.dk),
                               static_cast<float*>(a.dv), a.Sq, a.Sk, a.Hq, a.Hkv, a.causal,
                               a.window, a.scale);
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  using L = Layout<T, D, Tile<T>::NS_DKV>;
  constexpr size_t smem = L::dkv_bytes;
  static_assert(smem <= kMaxSmem, "B4's tiles exceed the shared memory of a block");
  // no queries: dk and dv are zeros, and there is nothing to map
  if (a.Sq <= 0) {
    const size_t bytes = size_t(a.B) * a.Sk * a.Hkv * D * sizeof(T);
    const cudaError_t err = cudaMemsetAsync(a.dk, 0, bytes, a.stream);
    return err != cudaSuccess ? err : cudaMemsetAsync(a.dv, 0, bytes, a.stream);
  }
  Maps maps;
  cudaError_t err = make_maps<T, D>(&maps, a, true, L::NS);
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, float>::value) {
    const int c = dkv_cluster(a.B, a.Sk, a.Hkv, a.Hq / a.Hkv, true);
    if (c > 1) return launch_dkv_cluster<D>(a, maps, c);
  }
  static SmemOptIn opt_in;  // one per kernel instance
  err = opt_in_smem(opt_in, attn_dkv_kernel<T, D, false>, smem);
  if (err != cudaSuccess) return err;
  attn_dkv_kernel<T, D, false><<<dkv_grid(a.B, a.Sk, a.Hkv), THREADS, smem, a.stream>>>(
      maps, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Sq, a.Sk, a.Hq,
      a.Hkv, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// ------------------------------------------------- the wgmma launches

// B3's and B4's consumer warpgroups a block (wg::groups): B3 tiles the q
// rows of each q head, B4 the key rows of each kv head (B4 at D128: one,
// see DkvLayout)
int dq_groups(int B, int Sq, int Hq) { return wg::groups(long(B) * Hq, Sq); }
int dkv_groups(int B, int Sk, int Hkv, int D) {
  return D == 128 ? 1 : wg::groups(long(B) * Hkv, Sk);
}

template <int D, int NC>
cudaError_t launch_dq_wgmma(const Args& a) {
  using L = DqLayout<D, NC>;
  static_assert(L::bytes <= kMaxSmem, "B3's tiles exceed the shared memory of a block");
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t err = wg::map_rows(&tq, a.q, a.B, a.Sq, a.Hq, D, L::BQ);
  if (err == cudaSuccess) err = wg::map_rows(&tdo, a.dout, a.B, a.Sq, a.Hq, D, L::BQ);
  if (err == cudaSuccess) err = wg::map_rows(&tk, a.k, a.B, a.Sk, a.Hkv, D, L::BK);
  if (err == cudaSuccess) err = wg::map_rows(&tv, a.v, a.B, a.Sk, a.Hkv, D, L::BK);
  if (err != cudaSuccess) return err;
  static SmemOptIn opt_in;  // one per kernel instance
  err = opt_in_smem(opt_in, attn_dq_kernel_wgmma<D, NC>, L::bytes);
  if (err != cudaSuccess) return err;
  attn_dq_kernel_wgmma<D, NC>
      <<<dim3((a.Sq + L::BQ - 1) / L::BQ, a.Hq, a.B), L::THREADS, L::bytes, a.stream>>>(
          tq, tdo, tk, tv, a.lse, a.delta, static_cast<bf16*>(a.dq), a.Sq, a.Sk, a.Hq, a.Hkv,
          a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int D, int NC>
cudaError_t launch_dkv_wgmma(const Args& a) {
  using L = DkvLayout<D, NC>;
  static_assert(L::bytes <= kMaxSmem, "B4's tiles exceed the shared memory of a block");
  CUtensorMap tk, tv, tq, tdo;
  cudaError_t err = wg::map_rows(&tk, a.k, a.B, a.Sk, a.Hkv, D, L::BKR);
  if (err == cudaSuccess) err = wg::map_rows(&tv, a.v, a.B, a.Sk, a.Hkv, D, L::BKR);
  if (err == cudaSuccess) err = wg::map_rows(&tq, a.q, a.B, a.Sq, a.Hq, D, L::BN);
  if (err == cudaSuccess) err = wg::map_rows(&tdo, a.dout, a.B, a.Sq, a.Hq, D, L::BN);
  if (err != cudaSuccess) return err;
  static SmemOptIn opt_in;  // one per kernel instance
  err = opt_in_smem(opt_in, attn_dkv_kernel_wgmma<D, NC>, L::bytes);
  if (err != cudaSuccess) return err;
  attn_dkv_kernel_wgmma<D, NC>
      <<<dim3((a.Sk + L::BKR - 1) / L::BKR, a.Hkv, a.B), L::THREADS, L::bytes, a.stream>>>(
          tk, tv, tq, tdo, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
          a.Sq, a.Sk, a.Hq, a.Hkv, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// With no keys (B3) or no queries (B4) the gradients are zeros, and there
// is nothing to map: the outputs are cleared on the stream instead.
template <int D>
cudaError_t launch_wgmma(const Args& a, bool dkv) {
  if (!dkv) {
    if (a.Sk <= 0) return cudaMemsetAsync(a.dq, 0, size_t(a.B) * a.Sq * a.Hq * D * 2, a.stream);
    return dq_groups(a.B, a.Sq, a.Hq) == 2 ? launch_dq_wgmma<D, 2>(a) : launch_dq_wgmma<D, 1>(a);
  }
  if (a.Sq <= 0) {
    const size_t bytes = size_t(a.B) * a.Sk * a.Hkv * D * 2;
    const cudaError_t err = cudaMemsetAsync(a.dk, 0, bytes, a.stream);
    return err != cudaSuccess ? err : cudaMemsetAsync(a.dv, 0, bytes, a.stream);
  }
  if constexpr (D == 128)
    return launch_dkv_wgmma<D, 1>(a);
  else
    return dkv_groups(a.B, a.Sk, a.Hkv, D) == 2 ? launch_dkv_wgmma<D, 2>(a)
                                                : launch_dkv_wgmma<D, 1>(a);
}

// The (dtype, D) rule of the header: bf16 at D 64 and 128 runs the wgmma
// kernels, everything else the mma.sync ones (whose bf16 D64/D128
// instances are not built).
template <typename T>
cudaError_t dispatch(const Args& a, int D, bool dkv) {
#define REPRO_BWD_CASE(DIM) \
  case DIM: return dkv ? launch_dkv<T, DIM>(a) : launch_dq<T, DIM>(a);
#define REPRO_BWD_WGMMA_CASE(DIM)                                     \
  case DIM:                                                           \
    if constexpr (std::is_same<T, bf16>::value)                       \
      return launch_wgmma<DIM>(a, dkv);                               \
    else                                                              \
      return dkv ? launch_dkv<T, DIM>(a) : launch_dq<T, DIM>(a);
  switch (D) {  // the head dims of K1 (flash_attention.cu)
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_WGMMA_CASE(64)
    REPRO_BWD_WGMMA_CASE(128)
    REPRO_BWD_CASE(160)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_WGMMA_CASE
#undef REPRO_BWD_CASE
}

// The wgmma launch of B3 (dkv false) or B4 for these sizes: grid, threads,
// shared bytes.
template <int D>
void wgmma_plan(int B, int Sq, int Sk, int Hq, int Hkv, bool dkv, int64_t* out) {
  int nc, rows, threads;
  size_t smem;
  dim3 g;
  if (dkv) {
    nc = dkv_groups(B, Sk, Hkv, D);
    rows = 64 * nc;
    g = dim3((Sk + rows - 1) / rows, Hkv, B);
    threads = nc == 2 ? DkvLayout<D, 2>::THREADS : DkvLayout<D, 1>::THREADS;
    smem = nc == 2 ? DkvLayout<D, 2>::bytes : DkvLayout<D, 1>::bytes;
  } else {
    nc = dq_groups(B, Sq, Hq);
    rows = 64 * nc;
    g = dim3((Sq + rows - 1) / rows, Hq, B);
    threads = nc == 2 ? DqLayout<D, 2>::THREADS : DqLayout<D, 1>::THREADS;
    smem = nc == 2 ? DqLayout<D, 2>::bytes : DqLayout<D, 1>::bytes;
  }
  const int64_t v[6] = {g.x, g.y, g.z, threads, int64_t(smem), 1};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

// The launch of B3 (dkv false) or B4 for these sizes: grid, threads,
// shared bytes, cluster.
template <typename T>
int bwd_plan(int B, int Sq, int Sk, int Hq, int Hkv, int D, bool dkv, int64_t* out) {
  if (std::is_same<T, bf16>::value && (D == 64 || D == 128)) {
    if (D == 64)
      wgmma_plan<64>(B, Sq, Sk, Hq, Hkv, dkv, out);
    else
      wgmma_plan<128>(B, Sq, Sk, Hq, Hkv, dkv, out);
    return cudaSuccess;
  }
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
  const int c = dkv ? dkv_cluster(B, Sk, Hkv, Hq / Hkv, std::is_same<T, float>::value) : 1;
  const dim3 g = dkv ? dkv_grid(B, Sk, Hkv, c) : dq_grid(B, Sq, Hq);
  const int64_t v[6] = {g.x, g.y, g.z, THREADS, int64_t(smem), c};
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
  // TMA's 16-byte bases of q, k, v, dO; paired stores of dq, dk, dv
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
