"""Launcher of kernel K1, the CUDA flash-attention forward
(``csrc/flash_attention.cu``), which replaces the TPU kernel
``repro/kernels/flash_attention.py::_attn_kernel``. The checked, counted
entry point is :func:`repro_torch.kernels.ops.flash_attention`; this
module only hands pointers to the C function."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

# head dims the kernel is instantiated for (csrc/flash_attention.cu)
HEAD_DIMS = (16, 32, 64, 128, 160)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int) -> torch.Tensor:
    """q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D), contiguous CUDA tensors of one
    dtype (validated by the caller) -> (B,Sq,Hq,D) in q's dtype."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = _build.library().repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, Hq, Hkv, D, int(causal), int(window),
        1.0 / math.sqrt(D), _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    return out
