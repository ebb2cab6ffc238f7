"""Launcher of kernel K3, the CUDA RMSNorm forward (``csrc/rmsnorm.cu``),
which replaces the TPU kernel ``repro/kernels/rmsnorm.py::_rmsnorm_kernel``.
The checked, counted entry point is :func:`repro_torch.kernels.ops.rmsnorm`;
this module only allocates the output and hands pointers to the C function.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def rmsnorm_cuda(x2d: torch.Tensor, scale: torch.Tensor, eps: float,
                 threads: int = 0) -> torch.Tensor:
    """x2d (rows, d) contiguous CUDA tensor, scale (d,) f32 contiguous
    (validated by the caller) -> (rows, d) in x's dtype. ``threads``: a
    row's block (whole warps, 32 to 512), 0 for the C heuristic."""
    rows, d = x2d.shape
    out = torch.empty_like(x2d)
    err = _build.library().repro_rmsnorm_fwd(
        x2d.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, eps,
        _build.DTYPE_CODES[x2d.dtype], int(threads),
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(err, "rmsnorm")
    return out
