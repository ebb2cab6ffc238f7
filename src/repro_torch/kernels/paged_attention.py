"""Launcher of kernel K2, the CUDA paged decode attention
(``csrc/paged_attention.cu``), which replaces the TPU kernel
``repro/kernels/paged_attention.py::_paged_kernel``. The checked, counted
entry point is :func:`repro_torch.kernels.ops.paged_attention`; this
module only hands pointers to the C function."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

# the kernel stages K/V rows in vectors of VEC elements (csrc: VEC)
VEC = 4


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_tables: torch.Tensor,
                         lengths: torch.Tensor,
                         splits: int = 0) -> torch.Tensor:
    """q (B,1,Hq,D); pools (P,ps,Hkv,D); block_tables (B,n_pages) int32;
    lengths (B,) int32; contiguous CUDA tensors (validated by the caller)
    -> (B,1,Hq,D) in q's dtype. ``splits``: the split count (the cluster
    size, 1 to 8), 0 for the C heuristic."""
    B, _, Hq, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    err = _build.library().repro_paged_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, P, ps, Hq, Hkv, D, block_tables.shape[1], 1.0 / math.sqrt(D),
        _build.DTYPE_CODES[q.dtype], int(splits),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention")
    return out
