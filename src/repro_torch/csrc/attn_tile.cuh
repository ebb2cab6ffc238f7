// What the tensor-core flash-attention kernels share: the forward
// (flash_attention.cu: K1, B2) and the backward (flash_attention_bwd.cu: B3,
// B4). The mask, the masked-score value, log2(e) for exp2, and the
// alignment their 16-byte copies need.

#pragma once

#include <stddef.h>
#include <stdint.h>

namespace attn {

constexpr float NEG_INF = -1e30f;                 // the TPU kernels' masked score
constexpr float kLog2e = 1.4426950408889634f;     // exp(x) = exp2(x log2(e))

// Whether query position qp sees key position kp: inside the key length,
// causal (qp >= kp) if asked, and inside a nonzero window (qp - kp <
// window, one-sided, also without causal), as in the TPU kernels' masks.
__device__ __forceinline__ bool visible(int qp, int kp, int Sk, int causal, int window) {
  bool ok = kp < Sk;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && qp - kp < window;
  return ok;
}

inline bool aligned(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace attn
