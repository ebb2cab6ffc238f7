// RMSNorm forward (kernel K3) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (entry point rmsnorm_fwd). Same function: y = x * rsqrt(mean(x^2) + eps)
// * scale over the last axis, the statistics and the products in f32, the
// output in x's type (f32 or bf16); scale is (d,) f32.
//
// What bounds it on the H100: a few operations per element, so bytes (each
// row read once and written once, scale read once) over 3.35 TB/s, and at
// decode's few rows the launch and one DRAM round trip.
//
// Design: one block per row, sized so that a thread holds ELEMS elements
// of the row in 16-byte vectors (plain element loads where the row is not
// 16-byte aligned). A thread issues every load it needs at once, its
// slice of x (kept as loaded: bf16 stays packed, which keeps the kernel
// at 56-64 registers) and of scale (as f32), so the row costs one memory
// round trip before the reduction. The sum of squares goes through one
// fused multiply-add chain a thread, xor shuffles over a warp's lanes and
// the warps in warp order (a fixed order: two calls give the same bits);
// the thread then scales and stores the values it holds. Many rows keep
// many blocks resident on each SM, so one row's stores overlap other
// rows' loads.
//
// Built, timed against the earlier Triton kernel on the H100 and dropped
// (PERF.md, Findings): a row split over a thread-block cluster, combined
// through distributed shared memory (its barriers cost about 1 us at a
// decode step's 4 rows, more than the extra SMs save); persistent blocks
// streaming rows through a ring of bulk copies, a block or a warp per row
// (rows serialise inside a block: 1.4-1.5x slower at 512-1100 rows); scale
// loaded after the reduction (a second round trip); two rows a block.
//
// Layouts: x and out (rows, d) contiguous, scale (d,) f32.

#include <algorithm>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int ELEMS = 16;          // elements a thread holds
constexpr int MAX_THREADS = 512;   // a row's block

struct Args {
  const void* x;
  const float* scale;
  void* out;
  int d;
  float eps;
};

// 16 bytes of T: loaded and kept as they are (Raw), read as floats.
template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int N = 4;
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& a, float (&v)[N]) {
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
  static __device__ __forceinline__ void store(void* p, const float (&v)[N]) {
    __stcs(static_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& a, float (&v)[N]) {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(void* p, const float (&v)[N]) {
    __stcs(static_cast<uint4*>(p), make_uint4(mma::pack_bf16(v[0], v[1]), mma::pack_bf16(v[2], v[3]),
                                              mma::pack_bf16(v[4], v[5]), mma::pack_bf16(v[6], v[7])));
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A row's vector `idx` as loaded: 16 bytes (V > 1) or one element (V = 1).
// x and out are streamed (evict-first): a row is read and written once, so
// scale's lines, read by every row, stay in L2 when the rows overflow it.
template <typename T, int V>
using Raw = std::conditional_t<V == 1, T, typename Pack<T>::Raw>;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_x(const T* row, int idx) {
  if constexpr (V == 1)
    return __ldcs(row + idx);
  else
    return __ldcs(reinterpret_cast<const Raw<T, V>*>(row + size_t(idx) * V));
}
template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& raw, float (&v)[V]) {
  if constexpr (V == 1)
    v[0] = to_f32(raw);
  else
    Pack<T>::unpack(raw, v);
}
// V floats of scale at vector `idx` (16-byte loads where V > 1).
template <int V>
__device__ __forceinline__ void load_scale(const float* scale, int idx, float (&s)[V]) {
  if constexpr (V == 1) {
    s[0] = scale[idx];
  } else {
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      float q[4];
      Pack<float>::unpack(*reinterpret_cast<const float4*>(scale + size_t(idx) * V + e), q);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[e + i] = q[i];
    }
  }
}
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* row, int idx, const float (&v)[V]) {
  if constexpr (V == 1)
    __stcs(row + idx, from_f32<T>(v[0]));
  else
    Pack<T>::store(row + size_t(idx) * V, v);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// Row blockIdx.x; thread t holds vectors t, t + blockDim.x, ... of it as
// loaded, and of scale as floats (the first NREG of each; any further ones
// are loaded again for the store).
template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS) rmsnorm_kernel(Args a) {
  constexpr int NREG = ELEMS / V;
  __shared__ float red[MAX_THREADS / 32];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int nvec = a.d / V;
  const T* xr = static_cast<const T*>(a.x) + size_t(blockIdx.x) * a.d;
  T* yr = static_cast<T*>(a.out) + size_t(blockIdx.x) * a.d;
  Raw<T, V> x[NREG];
  float s[NREG][V];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NREG; ++j) {
    const int idx = tid + j * nthr;
    if (idx < nvec) {
      x[j] = load_x<T, V>(xr, idx);
      load_scale<V>(a.scale, idx, s[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < NREG; ++j) {
    if (tid + j * nthr < nvec) {
      float v[V];
      unpack<T, V>(x[j], v);
#pragma unroll
      for (int e = 0; e < V; ++e) ss = fmaf(v[e], v[e], ss);
    }
  }
  for (int idx = tid + NREG * nthr; idx < nvec; idx += nthr) {
    float v[V];
    unpack<T, V>(load_x<T, V>(xr, idx), v);
#pragma unroll
    for (int e = 0; e < V; ++e) ss = fmaf(v[e], v[e], ss);
  }
  ss = warp_sum(ss);
  if ((tid & 31) == 0) red[tid >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < (nthr >> 5); ++w) total += red[w];
  const float r = rsqrtf(total / float(a.d) + a.eps);
#pragma unroll
  for (int j = 0; j < NREG; ++j) {
    const int idx = tid + j * nthr;
    if (idx < nvec) {
      float v[V];
      unpack<T, V>(x[j], v);
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = v[e] * r * s[j][e];
      store_vec<T, V>(yr, idx, v);
    }
  }
  for (int idx = tid + NREG * nthr; idx < nvec; idx += nthr) {
    float v[V], w[V];
    unpack<T, V>(load_x<T, V>(xr, idx), v);
    load_scale<V>(a.scale, idx, w);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = v[e] * r * w[e];
    store_vec<T, V>(yr, idx, v);
  }
}

// The vector width (16 bytes, or 1 element where x, out or scale is not on
// a 16-byte boundary or d is not whole vectors) and the block's threads:
// enough for ELEMS elements each, in whole warps, at most MAX_THREADS.
struct Plan {
  int vec, threads;
};

Plan make_plan(const void* x, const void* scale, const void* out, int d, int V) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
                          reinterpret_cast<uintptr_t>(out);
  const int vec = bases % 16 == 0 && d % V == 0 ? V : 1;
  const int nreg = ELEMS / vec;
  const int per_thread = (d / vec + nreg - 1) / nreg;
  return {vec, std::min(MAX_THREADS, std::max(32, (per_thread + 31) / 32 * 32))};
}

template <typename T>
cudaError_t launch(const Args& a, int rows, cudaStream_t stream) {
  const Plan p = make_plan(a.x, a.scale, a.out, a.d, Pack<T>::N);
  if (p.vec == 1)
    rmsnorm_kernel<T, 1><<<rows, p.threads, 0, stream>>>(a);
  else
    rmsnorm_kernel<T, Pack<T>::N><<<rows, p.threads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaGetLastError().
extern "C" int repro_rmsnorm_fwd(const void* x, const void* scale, void* out, int rows, int d,
                                 float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return cudaSuccess;
  const Args a = {x, static_cast<const float*>(scale), out, d, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? launch<float>(a, rows, s)
                    : dtype == 1 ? launch<__nv_bfloat16>(a, rows, s)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
