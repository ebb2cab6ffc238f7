"""Launcher of kernel B6, the CUDA chunked WKV6 (``csrc/wkv6.cu``), which
replaces the TPU kernel ``repro/kernels/rwkv6.py::_wkv_kernel``. The
checked, counted entry point is :func:`repro_torch.kernels.ops.wkv6`;
this module only allocates the outputs and hands pointers and element
strides to the C function."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_DIM = 64    # largest K and V the kernel takes (csrc: KMAX)


def wkv6_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              ld: torch.Tensor, u) -> tuple:
    """q, k, ld (B,T,H,K), v (B,T,H,V) CUDA tensors of any strides; u (H,K)
    f32 contiguous or None (validated by the caller) -> (o (B,T,H,V) in
    q's dtype, state (B,H,K,V) f32), from a zero initial state."""
    B, T, H, K = q.shape
    V = v.shape[-1]
    o = torch.empty((B, T, H, V), dtype=q.dtype, device=q.device)
    state = torch.empty((B, H, K, V), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 16)(*(s for t in (q, k, v, ld)
                                      for s in t.stride()))
    err = _build.library().repro_wkv6_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld.data_ptr(),
        None if u is None else u.data_ptr(), o.data_ptr(), state.data_ptr(),
        ctypes.addressof(strides), B, T, H, K, V,
        _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[ld.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "wkv6")
    return o, state
