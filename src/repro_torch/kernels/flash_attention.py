"""Launchers of the CUDA flash-attention kernels: K1, the forward
(``csrc/flash_attention.cu``, replacing
``repro/kernels/flash_attention.py::_attn_kernel``); B2, the same kernel
with the logsumexp rows (``_attn_kernel_lse``); B3 and B4, the backward's
dq and dk/dv kernels (``csrc/flash_attention_bwd.cu``, replacing
``_dq_kernel`` and ``_dkv_kernel``). The checked, counted, differentiable
entry point is :func:`repro_torch.kernels.ops.flash_attention`; this
module only allocates the outputs and hands pointers to the C functions."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

# head dims the kernels are instantiated for (csrc/flash_attention*.cu)
HEAD_DIMS = (16, 32, 64, 128, 160)


def _dims(q, k, causal: bool, window: int) -> tuple:
    """The size, mask, scale and dtype arguments the C functions share:
    B, Sq, Sk, Hq, Hkv, D, causal, window, scale, dtype."""
    B, Sq, Hq, D = q.shape
    return (B, Sq, k.shape[1], Hq, k.shape[2], D, int(causal), int(window),
            1.0 / math.sqrt(D), _build.DTYPE_CODES[q.dtype])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int) -> torch.Tensor:
    """K1. q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D), contiguous CUDA tensors of one
    dtype (validated by the caller) -> (B,Sq,Hq,D) in q's dtype."""
    out = torch.empty_like(q)
    err = _build.library().repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *_dims(q, k, causal, window), _stream(q))
    _build.check(err, "flash_attention")
    return out


def flash_attention_lse_cuda(q, k, v, *, causal: bool, window: int):
    """B2: K1's output and lse (B,Hq,Sq) f32."""
    B, Sq, Hq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    err = _build.library().repro_flash_attention_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *_dims(q, k, causal, window), _stream(q))
    _build.check(err, "flash_attention_lse")
    return out, lse


def flash_attention_dq_cuda(q, k, v, do, lse, delta, *, causal: bool,
                            window: int) -> torch.Tensor:
    """B3: dq (B,Sq,Hq,D) in q's dtype; do like q, lse and delta
    (B,Hq,Sq) f32, all contiguous."""
    dq = torch.empty_like(q)
    err = _build.library().repro_flash_attention_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_dims(q, k, causal, window), _stream(q))
    _build.check(err, "flash_attention_dq")
    return dq


def flash_attention_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool,
                             window: int):
    """B4: (dk, dv), each (B,Sk,Hkv,D) in k's dtype, summed over each GQA
    group inside the kernel."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.library().repro_flash_attention_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_dims(q, k, causal, window), _stream(q))
    _build.check(err, "flash_attention_dkv")
    return dk, dv
