// Tile sizes and dtype conversions of the FMA flash-attention kernels
// (flash_attention.cu: K1 and B2), which compute in f32 whatever their input
// type (T is float or __nv_bfloat16), and the mask they share with the
// tensor-core backward (flash_attention_bwd.cu: B3, B4).

#pragma once

#include <cuda_bf16.h>

namespace attn {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 row groups of 4 rows x 16 column lanes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Whether query position qp sees key position kp: inside the key length,
// causal (qp >= kp) if asked, and inside a nonzero window (qp - kp <
// window, one-sided, also without causal), as in the TPU kernels' masks.
__device__ __forceinline__ bool visible(int qp, int kp, int Sk, int causal, int window) {
  bool ok = kp < Sk;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && qp - kp < window;
  return ok;
}

}  // namespace attn
