// Paged decode attention over a block-table KV pool (kernel K2), split over
// the sequence and combined inside one launch.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_paged_kernel
// (entry point paged_attention_fwd). Same function: one query token per row
// attends to the row's KV history, stored in scattered fixed-size pages of a
// global pool and addressed through the row's block table; pages at or past
// ceil(lengths[b] / page_size) are never read, keys at or past lengths[b]
// inside the last page are masked, softmax and accumulation run in f32 with
// the row sum clamped at 1e-30, and the output is in q's type.
//
// What bounds it on the H100: each K/V byte read takes part in one
// multiply-add per query head of its group (g = Hq / Hkv, 4 on granite), far
// below the ~20 f32 operations per byte at which the card stops being bound
// by memory, so the bound is the bytes of the live pages, and the lever is
// bytes in flight on every SM. Each live page of each kv head is read once,
// for all query heads of its group (the GQA group is the row tile, as in the
// TPU kernel).
//
// Design (flash decoding in one launch): the grid is (nsplit, Hkv x head
// groups, B), and the nsplit blocks of one (row, kv head) form a thread-block
// cluster. Each block reads its row's length on the device and takes its own
// share of the ceil(len / page_size) live pages, so the table's width (the
// engine's cache span) costs nothing and the host never learns the lengths.
// The launcher picks nsplit (at most 8, the portable cluster size) so that
// the grid fills the SMs: 4 at granite's decode batch of 4, 8 at batch 1;
// a caller may ask for another (kernels/tuning.py).
// Inside a block the keys and values stream through a three-stage ring of
// TK-token tiles, one copy-engine (bulk) copy per K or V row completing on
// the stage's mbarrier (8-byte cp.async where the pool is only 8-byte
// aligned; bulk copies were 2-7% faster than 16-byte cp.async on the H100,
// PERF.md). The block-table entry is resolved once per
// token, a stage ahead: lane i of a warp loads the entry of the warp's
// token i, all in one latency. A page entry outside [0, P) is read as the
// null page 0, and a retired row whose table is all null reads page 0,
// which the allocator never issues. Each of the 8 warps owns a token of
// every 8 and keeps its own online softmax: the whole warp computes a
// token's score (each lane a 4-element column of the row, then a shuffle
// reduction), and each lane accumulates P V for its columns in registers,
// so no thread walks a row or a tile alone. At the end the warps' (m, l,
// acc) are combined in shared memory in warp order, and the cluster's
// blocks combine theirs through distributed shared memory in split order,
// each block finishing a slice of the output: m = max m_i, l = sum l_i
// e^{m_i - m}, acc likewise, out = acc / max(l, 1e-30). An empty split
// contributes m = -1e30 and l = 0. No scratch, no counters, no atomics:
// two calls give the same bits.
//
// Layouts: q (B, 1, Hq, D); pools (P, page_size, Hkv, D) with D a multiple
// of 4 and 4-element-aligned base pointers; block table (B, n_pages) int32;
// lengths (B,) int32; out (B, 1, Hq, D); all contiguous.

#include <algorithm>
#include <mutex>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "mma.cuh"
#include "smem_opt_in.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NSTAGE = 3;     // ring depth: two tiles in flight while one is used
constexpr int MAX_SPLIT = 8;  // portable cluster size
constexpr int VEC = 4;        // elements per lane column
constexpr float NEG_INF = -1e30f;

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// NC: 4-element columns per lane (D <= 128 NC); GH: query heads per block;
// TK: tokens per ring stage (the ring holds NSTAGE x TK rows of K and V).
template <int NC> struct Shape {
  static constexpr int GH = NC <= 2 ? 4 : 8 / NC;
  static constexpr int TK = 32 / NC;
  static constexpr int TKW = (TK + WARPS - 1) / WARPS;  // tokens per warp per stage
};

// Bytes of the ring, and of the warps' partial results that reuse it.
size_t ring_bytes(int NC, int D, int es) {
  return size_t(NSTAGE) * 2 * (32 / NC) * D * es;
}
size_t partial_bytes(int GH, int D) { return sizeof(float) * size_t(WARPS) * GH * (D + 2); }

// The stages' mbarriers, after the ring and the block's (m, l, acc).
__host__ __device__ inline size_t bar_offset(size_t ring, int GH, int D) {
  return (ring + sizeof(float) * GH * (D + 2) + 15) / 16 * 16;
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ o, int P, int ps, int Hq,
                    int Hkv, int D, int npag, int ngroups, float scale, int bulk,
                    size_t ring) {
  using S = Shape<NC>;
  constexpr int GH = S::GH, TK = S::TK, TKW = S::TKW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ring = reinterpret_cast<T*>(smem);
  float* Bm = reinterpret_cast<float*>(smem + ring);  // this block's m, l, acc
  float* Bl = Bm + GH;
  float* Bacc = Bl + GH;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + bar_offset(ring, GH, D));  // one per stage

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int hk = blockIdx.y / ngroups, grp = blockIdx.y - hk * ngroups;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = Hq / Hkv, h0 = grp * GH, gh = min(GH, g - h0);
  const int ncol = D / VEC;
  const size_t q_base = (size_t(b) * Hq + size_t(hk) * g + h0) * D;

  // this split's share of the live pages, in tokens [tb, te)
  const int len = lengths[b];
  const int n_live = len > 0 ? min((len + ps - 1) / ps, npag) : 0;
  const int pps = (n_live + nsplit - 1) / nsplit;
  const int pb = min(n_live, split * pps), pe = min(n_live, pb + pps);
  const int tb = pb * ps, te = min(pe * ps, len);
  const int nsteps = te > tb ? (te - tb + TK - 1) / TK : 0;
  const int* btab = block_tables + size_t(b) * npag;

  // q for this lane's columns, per head, scaled by scale log2(e): scores,
  // m and the exponentials below are in base 2
  const float qscale = scale * 1.4426950408889634f;
  float qr[GH][NC][VEC];
#pragma unroll
  for (int hh = 0; hh < GH; ++hh)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      const T* qp = q + q_base + size_t(hh) * D + c * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[hh][j][e] = hh < gh && c < ncol ? to_f32(qp[e]) * qscale : 0.f;
    }

  // stage s of the ring: K rows then V rows of TK tokens from tb + s TK
  const int rowb = D * sizeof(T);  // bytes of a K or V row
  // the physical page of this warp's token i of a step, in lane i: the
  // TKW lanes load together, one latency for the warp's tokens (-1 past
  // the split's end; an entry outside [0, P) reads the null page 0)
  auto entry = [&](int step) {
    int e = -1;
    const int r = warp + WARPS * lane, tok = tb + step * TK + r;
    if (lane < TKW && r < TK && tok < te) {
      e = __ldg(btab + tok / ps);
      if (e < 0 || e >= P) e = 0;
    }
    return e;
  };
  // Stage `step` into its ring slot: with `bulk`, one copy-engine copy per
  // K or V row by the lane that holds its table entry, counted on the
  // slot's mbarrier (thread 0 declares the stage's bytes); otherwise 8-byte
  // cp.async by the whole warp.
  auto issue = [&](int step, int ent) {
    const int slot = step % NSTAGE;
    T* kd = Ring + size_t(slot) * 2 * TK * D;
    T* vd = kd + TK * D;
    if (bulk && tid == 0)
      mma::mbar_arrive_expect(&bars[slot], uint32_t(min(TK, te - tb - step * TK)) * 2 * rowb);
#pragma unroll
    for (int i = 0; i < TKW; ++i) {
      const int r = warp + WARPS * i;  // the same in every lane
      const int phys = bulk ? ent : __shfl_sync(0xffffffffu, ent, i);
      if (r >= TK) break;
      const int tok = tb + step * TK + r;
      const size_t off =
          phys >= 0 ? ((size_t(phys) * ps + tok % ps) * Hkv + hk) * D : 0;
      if (bulk) {
        if (lane == i && phys >= 0) {
          mma::fence_proxy_async();
          mma::bulk_copy(kd + r * D, k_pages + off, rowb, &bars[slot]);
          mma::bulk_copy(vd + r * D, v_pages + off, rowb, &bars[slot]);
        }
      } else {
        const int n = phys >= 0 ? 8 : 0;
        const char* ks = reinterpret_cast<const char*>(k_pages + off);
        const char* vs = reinterpret_cast<const char*>(v_pages + off);
        char* kr = reinterpret_cast<char*>(kd + r * D);
        char* vr = reinterpret_cast<char*>(vd + r * D);
        for (int c = lane; c < rowb / 8; c += 32) {
          mma::cp_async8_n(kr + c * 8, ks + c * 8, n);
          mma::cp_async8_n(vr + c * 8, vs + c * 8, n);
        }
      }
    }
  };

  float m[GH], l[GH], acc[GH][NC][VEC];
#pragma unroll
  for (int hh = 0; hh < GH; ++hh) {
    m[hh] = NEG_INF, l[hh] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[hh][j][e] = 0.f;
  }

  // the first NSTAGE - 1 stages, their table entries loaded together; the
  // next stage's entries then load a step ahead of their copies
  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) mma::mbar_init(&bars[s], 1);
    mma::mbar_fence_init();
  }
  int ent[NSTAGE - 1];
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) ent[s] = entry(s);
  __syncthreads();  // the mbarriers are initialised
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nsteps) issue(s, ent[s]);
    mma::cp_async_commit();
  }
  int next = entry(NSTAGE - 1);
  for (int step = 0; step < nsteps; ++step) {
    if (bulk)
      mma::mbar_wait(&bars[step % NSTAGE], (step / NSTAGE) & 1);
    else
      mma::cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // this step's tile is in; the slot refilled below is free
    if (step + NSTAGE - 1 < nsteps) issue(step + NSTAGE - 1, next);
    mma::cp_async_commit();
    next = entry(step + NSTAGE);
    const T* kt = Ring + size_t(step % NSTAGE) * 2 * TK * D;
    const T* vt = kt + TK * D;

    // scores of this warp's tokens, every lane holding every value
    float sc[TKW][GH];
    bool ok[TKW];
#pragma unroll
    for (int i = 0; i < TKW; ++i) {
      const int r = warp + WARPS * i;
      ok[i] = r < TK && tb + step * TK + r < te;
      float part[GH];
#pragma unroll
      for (int hh = 0; hh < GH; ++hh) part[hh] = 0.f;
      if (ok[i]) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = lane + 32 * j;
          if (c < ncol) {
            float kv[VEC];
            load4(kt + r * D + c * VEC, kv);
#pragma unroll
            for (int hh = 0; hh < GH; ++hh)
#pragma unroll
              for (int e = 0; e < VEC; ++e) part[hh] = fmaf(qr[hh][j][e], kv[e], part[hh]);
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < GH; ++hh) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part[hh] += __shfl_xor_sync(0xffffffffu, part[hh], off);
        sc[i][hh] = part[hh];
      }
    }
    // online softmax per head, then P V for this lane's columns
    float pr[TKW][GH];
#pragma unroll
    for (int hh = 0; hh < GH; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int i = 0; i < TKW; ++i)
        if (ok[i]) mx = fmaxf(mx, sc[i][hh]);
      const float corr = exp2f(m[hh] - mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < TKW; ++i) {
        pr[i][hh] = ok[i] ? exp2f(sc[i][hh] - mx) : 0.f;
        sum += pr[i][hh];
      }
      m[hh] = mx;
      l[hh] = l[hh] * corr + sum;
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[hh][j][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < TKW; ++i) {
      if (!ok[i]) continue;
      const int r = warp + WARPS * i;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        if (c >= ncol) continue;
        float vv[VEC];
        load4(vt + r * D + c * VEC, vv);
#pragma unroll
        for (int hh = 0; hh < GH; ++hh)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[hh][j][e] = fmaf(pr[i][hh], vv[e], acc[hh][j][e]);
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' partials go there

  // the block's result: the 8 warps' (m, l, acc) combined in warp order
  float* Wm = reinterpret_cast<float*>(smem);   // [WARPS][GH]
  float* Wl = Wm + WARPS * GH;                  // [WARPS][GH]
  float* Wacc = Wl + WARPS * GH;                // [WARPS][GH][D]
  if (lane == 0) {
#pragma unroll
    for (int hh = 0; hh < GH; ++hh) Wm[warp * GH + hh] = m[hh], Wl[warp * GH + hh] = l[hh];
  }
#pragma unroll
  for (int hh = 0; hh < GH; ++hh)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < ncol)
        *reinterpret_cast<float4*>(Wacc + (size_t(warp) * GH + hh) * D + c * VEC) =
            make_float4(acc[hh][j][0], acc[hh][j][1], acc[hh][j][2], acc[hh][j][3]);
    }
  __syncthreads();
  for (int idx = tid; idx < GH * D; idx += THREADS) {
    const int hh = idx / D;
    float mx = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, Wm[w * GH + hh]);
    float a = 0.f;
    for (int w = 0; w < WARPS; ++w)
      a += Wacc[size_t(w) * GH * D + idx] * exp2f(Wm[w * GH + hh] - mx);
    Bacc[idx] = a;
  }
  if (tid < GH) {
    float mx = NEG_INF, a = 0.f;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, Wm[w * GH + tid]);
    for (int w = 0; w < WARPS; ++w) a += Wl[w * GH + tid] * exp2f(Wm[w * GH + tid] - mx);
    Bm[tid] = mx;
    Bl[tid] = a;
  }

  // the cluster's splits combined in split order, each block a slice of
  // the output
  cluster.sync();
  const int n_out = gh * D;
  const int per = (n_out + nsplit - 1) / nsplit;
  for (int idx = split * per + tid; idx < min(n_out, (split + 1) * per); idx += THREADS) {
    const int hh = idx / D;
    float mx = NEG_INF;
    for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, cluster.map_shared_rank(Bm, s)[hh]);
    float a = 0.f, ls = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = exp2f(cluster.map_shared_rank(Bm, s)[hh] - mx);
      a += cluster.map_shared_rank(Bacc, s)[idx] * w;
      ls += cluster.map_shared_rank(Bl, s)[hh] * w;
    }
    o[q_base + idx] = from_f32<T>(a / fmaxf(ls, 1e-30f));
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The launch of one call: the column bucket NC (4-element columns per
// lane, D <= 128 NC), grid (nsplit, Hkv x head groups, B), threads,
// dynamic shared memory (the ring, or the warps' partials that reuse it,
// then the block's (m, l, acc) and the stages' mbarriers) and the cluster
// (the nsplit blocks of one row and kv head). ``splits`` = 0 is the
// heuristic: at most MAX_SPLIT (the portable cluster size) and the live
// pages' bound npag, so that the grid fills the SMs; an explicit count is
// clamped to npag, as the reference clamps its pages_per_block. Returns
// false for a split count outside [0, MAX_SPLIT].
struct Plan {
  int nc, gh, ngroups, nsplit;
  size_t ring, smem;
};

int column_bucket(int D) {
  const int nc = (D / VEC + 31) / 32;
  return nc <= 1 ? 1 : nc <= 2 ? 2 : nc <= 4 ? 4 : 8;
}

int default_splits(long pairs, int npag, int sms) {
  return int(std::max(1L, std::min<long>({long(MAX_SPLIT), long(npag), sms / pairs})));
}

int sm_count() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

bool make_plan(int B, int Hq, int Hkv, int D, int npag, int es, int splits, Plan& p) {
  if (splits < 0 || splits > MAX_SPLIT) return false;
  p.nc = column_bucket(D);
  p.gh = p.nc <= 2 ? 4 : 8 / p.nc;  // Shape<NC>::GH
  const int g = Hq / Hkv;
  p.ngroups = (g + p.gh - 1) / p.gh;
  p.ring = std::max(ring_bytes(p.nc, D, es), partial_bytes(p.gh, D));
  p.smem = bar_offset(p.ring, p.gh, D) + sizeof(uint64_t) * NSTAGE;
  p.nsplit = splits > 0 ? std::min(splits, npag)
                        : default_splits(long(B) * Hkv * p.ngroups, npag, sm_count());
  return true;
}

// Whether clusters of nsplit blocks of this kernel, each with smem bytes of
// shared memory, can be resident at all (cudaOccupancyMaxActiveClusters >
// 0), asked once per (kernel instance, nsplit, size).
struct ClusterFit {
  std::mutex mu;
  size_t fits[MAX_SPLIT + 1] = {};  // largest size known to fit, per nsplit
};

template <typename Kernel>
cudaError_t check_cluster(ClusterFit& state, Kernel kernel, const cudaLaunchConfig_t& cfg,
                          int nsplit, size_t smem) {
  std::lock_guard<std::mutex> lock(state.mu);
  if (smem <= state.fits[nsplit]) return cudaSuccess;
  int n = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaErrorInvalidConfiguration;
  state.fits[nsplit] = smem;
  return cudaSuccess;
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* btab,
                   const int* lengths, void* o, int B, int P, int ps, int Hq, int Hkv, int D,
                   int npag, float scale, bool bulk, const Plan& p, cudaStream_t stream) {
  static SmemOptIn opt_in;  // one per kernel instance
  static ClusterFit fit;
  if (p.gh != Shape<NC>::GH) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem(opt_in, paged_decode_kernel<T, NC>, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nsplit, Hkv * p.ngroups, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = check_cluster(fit, paged_decode_kernel<T, NC>, cfg, p.nsplit, p.smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, paged_decode_kernel<T, NC>, static_cast<const T*>(q),
                           static_cast<const T*>(kp), static_cast<const T*>(vp), btab, lengths,
                           static_cast<T*>(o), P, ps, Hq, Hkv, D, npag, p.ngroups, scale,
                           int(bulk), p.ring);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_nc(const void* q, const void* kp, const void* vp, const int* btab,
                        const int* lengths, void* o, int B, int P, int ps, int Hq, int Hkv, int D,
                        int npag, float scale, bool bulk, const Plan& p, cudaStream_t s) {
  if (p.nc == 1)
    return launch<T, 1>(q, kp, vp, btab, lengths, o, B, P, ps, Hq, Hkv, D, npag, scale, bulk, p, s);
  if (p.nc == 2)
    return launch<T, 2>(q, kp, vp, btab, lengths, o, B, P, ps, Hq, Hkv, D, npag, scale, bulk, p, s);
  if (p.nc == 4)
    return launch<T, 4>(q, kp, vp, btab, lengths, o, B, P, ps, Hq, Hkv, D, npag, scale, bulk, p, s);
  return launch<T, 8>(q, kp, vp, btab, lengths, o, B, P, ps, Hq, Hkv, D, npag, scale, bulk, p, s);
}

// The sizes every entry point takes: whole 4-element columns of at most
// 32 x 8 per lane.
bool valid_dims(int Hq, int Hkv, int ps, int npag, int D) {
  return Hkv > 0 && Hq % Hkv == 0 && ps > 0 && npag > 0 && D > 0 && D % VEC == 0 &&
         D / VEC <= 32 * 8;
}

// What the card makes of the launch repro_paged_attention_fwd would make
// for these sizes and split count: out[0] = cudaOccupancyMaxActiveClusters
// (clusters of nsplit blocks resident at once; 0: none fits), out[1] =
// cudaOccupancyMaxPotentialClusterSize (the largest cluster of this
// kernel, portable sizes only). Launches nothing.
template <typename T, int NC>
int cluster_report(int B, int Hkv, const Plan& p, int64_t* out) {
  static SmemOptIn opt_in;
  cudaError_t err = opt_in_smem(opt_in, paged_decode_kernel<T, NC>, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nsplit, Hkv * p.ngroups, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0, size = 0;
  err = cudaOccupancyMaxActiveClusters(&active, paged_decode_kernel<T, NC>, &cfg);
  if (err != cudaSuccess) return err;
  cfg.numAttrs = 0;
  err = cudaOccupancyMaxPotentialClusterSize(&size, paged_decode_kernel<T, NC>, &cfg);
  if (err != cudaSuccess) return err;
  out[0] = active;
  out[1] = size;
  return cudaSuccess;
}

template <typename T>
int cluster_report_nc(int B, int Hkv, const Plan& p, int64_t* out) {
  if (p.nc == 1) return cluster_report<T, 1>(B, Hkv, p, out);
  if (p.nc == 2) return cluster_report<T, 2>(B, Hkv, p, out);
  if (p.nc == 4) return cluster_report<T, 4>(B, Hkv, p, out);
  return cluster_report<T, 8>(B, Hkv, p, out);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; splits: the split count (the cluster
// size), 1 to 8, or 0 for the heuristic. Returns the launch's
// cudaGetLastError() (cudaErrorInvalidConfiguration where a cluster of
// that many blocks cannot be resident).
extern "C" int repro_paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                         const void* block_tables, const void* lengths, void* o,
                                         int B, int P, int ps, int Hq, int Hkv, int D, int npag,
                                         float scale, int dtype, int splits, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (!valid_dims(Hq, Hkv, ps, npag, D) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  // on 4-element boundaries
  const size_t esize = dtype == 1 ? 2 : 4;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(k_pages) | reinterpret_cast<uintptr_t>(v_pages);
  if (bases % (VEC * esize) != 0) return cudaErrorInvalidValue;
  Plan p;
  if (!make_plan(B, Hq, Hkv, D, npag, int(esize), splits, p)) return cudaErrorInvalidValue;
  // bulk copies where every row starts on a 16-byte boundary and is a
  // multiple of 16 bytes long, 8-byte cp.async otherwise
  const bool bulk = bases % 16 == 0 && (D * esize) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  cudaError_t err =
      dtype == 0 ? dispatch_nc<float>(q, k_pages, v_pages, bt, ln, o, B, P, ps, Hq, Hkv, D, npag,
                                      scale, bulk, p, s)
                 : dispatch_nc<__nv_bfloat16>(q, k_pages, v_pages, bt, ln, o, B, P, ps, Hq, Hkv,
                                              D, npag, scale, bulk, p, s);
  return static_cast<int>(err);
}

// The launch repro_paged_attention_fwd makes for these sizes and split
// count, computed by the same make_plan: out = grid x, y, z, threads,
// dynamic shared bytes, cluster x. Launches nothing.
extern "C" int repro_paged_attention_plan(int B, int P, int ps, int Hq, int Hkv, int D, int npag,
                                          int dtype, int splits, int64_t* out) {
  (void)P;
  Plan p;
  if (B <= 0 || !valid_dims(Hq, Hkv, ps, npag, D) || (dtype != 0 && dtype != 1) ||
      !make_plan(B, Hq, Hkv, D, npag, dtype == 1 ? 2 : 4, splits, p))
    return cudaErrorInvalidValue;
  const int64_t v[6] = {p.nsplit, int64_t(Hkv) * p.ngroups, B, THREADS, int64_t(p.smem), p.nsplit};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return cudaSuccess;
}

extern "C" int repro_paged_attention_clusters(int B, int P, int ps, int Hq, int Hkv, int D,
                                              int npag, int dtype, int splits, int64_t* out) {
  (void)P;
  Plan p;
  if (B <= 0 || !valid_dims(Hq, Hkv, ps, npag, D) || (dtype != 0 && dtype != 1) ||
      !make_plan(B, Hq, Hkv, D, npag, dtype == 1 ? 2 : 4, splits, p))
    return cudaErrorInvalidValue;
  return dtype == 0 ? cluster_report_nc<float>(B, Hkv, p, out)
                    : cluster_report_nc<__nv_bfloat16>(B, Hkv, p, out);
}
