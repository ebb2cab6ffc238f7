// What the mma.sync flash-attention kernels share: the forward's
// (flash_attention.cu: K1, B2 in f32, and in bf16 at D 16/32/160) and the
// backward's (flash_attention_bwd.cu: B3, B4). Tiles stream into shared
// memory by TMA through a ring refilled by the last warp to release a
// stage, with no block barrier a step; the score products read their tf32
// fragments by ldmatrix; where a grid underfills the card, a launch splits
// its work over thread-block clusters of up to MAX_CLUSTER blocks.
//
// Tiles keep padded rows of D + PAD elements (conflict-free fragment reads):
// a TMA box of D + PAD columns, whose columns past D read zeros, lands as
// those rows (Maps, wg::map_box). The ring's control sits after the tiles:
// mbarrier 0 the resident tiles' full, mbarrier 1 + s stage s's full (each
// completed by one arrival with its bytes and the copies' transactions),
// then per stage the count of warps that have released it (release). The
// warp whose release is a stage's last refills it with the step STAGES
// ahead, so no warp waits to refill a stage, only for a stage's copies to
// land.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "mma.cuh"
#include "wgmma.cuh"

namespace attn {

constexpr int MAX_CLUSTER = 8;  // the portable cluster size

// The tensor maps of q, dO, k and v (the forward leaves dout unset), boxes
// of D + PAD columns and of the resident or streamed tiles' rows.
struct Maps {
  CUtensorMap q, dout, k, v;
};

// Bytes of the ring's control for STAGES stages: the 1 + STAGES mbarriers,
// then the release counts, in whole 8-byte words.
__host__ __device__ constexpr size_t ring_ctl_bytes(int stages) {
  return 8 * (1 + stages) + 8 * ((stages + 1) / 2);
}

struct Ring {
  uint32_t bar;        // shared address of mbarrier 0
  uint32_t* released;  // one count per stage
  __device__ uint32_t full(int s) const { return bar + 8 * (1 + s); }
};

// The block's shared memory from its first 128-byte boundary (TMA's
// destinations).
__device__ __forceinline__ unsigned char* aligned128(unsigned char* smem_raw) {
  return smem_raw + (128 - mma::smem_addr(smem_raw) % 128) % 128;
}

// The ring's control at ctl (ring_ctl_bytes(STAGES) bytes), set up by
// thread 0 before a barrier of the whole block.
template <int STAGES>
__device__ __forceinline__ Ring init_ring(unsigned char* ctl) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(ctl);
  Ring r{mma::smem_addr(ctl), reinterpret_cast<uint32_t*>(ctl + 8 * (1 + STAGES))};
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) mma::mbar_init(bars + i, 1);
    for (int s = 0; s < STAGES; ++s) r.released[s] = 0;
    mma::mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// Lane 0, once its warp has read all of stage s: counts the release
// (acquire-release, so that the last releaser's copies follow every warp's
// reads) and returns whether it was the stage's last of the block's WARPS.
template <int WARPS>
__device__ __forceinline__ bool release(const Ring& r, int s) {
  uint32_t old;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "r"(mma::smem_addr(r.released + s))
               : "memory");
  return old % WARPS == WARPS - 1;
}

// -------------------------------------------------------- warp products
// (mma.cuh: a warp's 16 rows are g = lane / 4 and g + 8; its C fragment
// for 8-column tile i holds columns 8i + 2t and 8i + 2t + 1, t = lane % 4)

// acc (16 x 8NT) = A B^T over D, A a 16-row tile, B an 8NT-row tile, both
// of row stride LD: the score products. f32 as 3xTF32 (the small terms in
// their own accumulators, added at the end), every fragment read by
// ldmatrix_x4 (A's four registers in one, B's two tiles' in one): the same
// products in the same order as 32-bit scalar reads, so the same bits;
// with PRE, A holds hi = tf32(a) and Alo lo = tf32(a - hi), split once per
// block, else A is split here. bf16: mma::warp_abt.
template <int D, int LD, int NT, bool PRE>
__device__ __forceinline__ void scores(float (&acc)[NT][4], const float* A, const float* Alo,
                                       const float* B, int lane) {
  static_assert(NT % 2 == 0, "B's tiles are read in pairs");
  const int m = lane >> 3, r = lane & 7;  // the matrix and row this lane addresses
  const int a_at = ((m & 1) * 8 + r) * LD + (m >> 1) * 4;
  const float* b_row = B + ((m >> 1) * 8 + r) * LD + (m & 1) * 4;
  float small[NT][4] = {};  // the lo*hi + hi*lo terms, added at the end
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 4
  for (int k = 0; k < D; k += 8) {
    uint32_t ahi[4], alo[4];
    if constexpr (PRE) {
      mma::ldmatrix_x4(ahi, A + a_at + k);
      mma::ldmatrix_x4(alo, Alo + a_at + k);
    } else {
      uint32_t a[4];
      mma::ldmatrix_x4(a, A + a_at + k);
      const float av[4] = {__uint_as_float(a[0]), __uint_as_float(a[1]), __uint_as_float(a[2]),
                           __uint_as_float(a[3])};
      mma::split4(ahi, alo, av);
    }
    mma::Tf32Pair b0[NT], b1[NT];
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t b[4];
      mma::ldmatrix_x4(b, b_row + 16 * j * LD + k);
      b0[2 * j] = mma::split_tf32(__uint_as_float(b[0]));
      b1[2 * j] = mma::split_tf32(__uint_as_float(b[1]));
      b0[2 * j + 1] = mma::split_tf32(__uint_as_float(b[2]));
      b1[2 * j + 1] = mma::split_tf32(__uint_as_float(b[3]));
    }
    mma::mma_3xtf32(acc, small, ahi, alo, b0, b1);
  }
  mma::add_into(acc, small);
}

template <int D, int LD, int NT, bool PRE>
__device__ __forceinline__ void scores(float (&acc)[NT][4], const __nv_bfloat16* A,
                                       const __nv_bfloat16*, const __nv_bfloat16* B, int lane) {
  mma::warp_abt<D, LD, NT>(acc, A, B, lane);
}

// A resident f32 tile of `rows` rows into TF32 hi (in place) and lo (rows
// of the same stride), by a block of THREADS threads, once: what PRE's
// score products read. The caller meets the block at a barrier after it.
template <int D, int LD, int THREADS>
__device__ __forceinline__ void split_rows(float* hi, float* lo, int rows) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int at = (i / D) * LD + i % D;
    const mma::Tf32Pair x = mma::split_tf32(hi[at]);
    hi[at] = __uint_as_float(x.hi);
    lo[at] = __uint_as_float(x.lo);
  }
}

// Writes a warp's C fragments (16 x 8NT) into rows of stride LDP.
template <int LDP, int NT, typename T>
__device__ __forceinline__ void store_tile(T* P, const float (&c)[NT][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    mma::store_pair(P + g * LDP + 8 * i + 2 * t, c[i][0], c[i][1]);
    mma::store_pair(P + (g + 8) * LDP + 8 * i + 2 * t, c[i][2], c[i][3]);
  }
}

// ------------------------------------------------------------- host side

// Launches `kernel` as clusters of c blocks along grid x. A cluster that
// cannot be resident (cudaOccupancyMaxActiveClusters 0, asked once per
// size; bit c of `resident` remembers a yes) raises
// cudaErrorInvalidConfiguration: nothing falls back to an unsplit launch.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), std::atomic<unsigned>& resident, dim3 grid,
                            int threads, size_t smem, cudaStream_t stream, int c, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!(resident.load(std::memory_order_relaxed) & (1u << c))) {
    int n = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (n <= 0) return cudaErrorInvalidConfiguration;
    resident.fetch_or(1u << c, std::memory_order_relaxed);
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace attn
