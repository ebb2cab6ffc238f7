"""Kernel K3: RMSNorm in Triton, replacing the TPU kernel
``repro/kernels/rmsnorm.py::_rmsnorm_kernel`` (entry point ``rmsnorm_fwd``).

Same function, forward only: ``x * rsqrt(mean(x^2) + eps) * scale`` with
the statistics and the products in f32 and the output in x's dtype.

What bounds it on the H100: a handful of operations per element, so the
bytes (each row read once, written once) bound it. The design keeps one
whole row in registers: one program per row with ``BLOCK_D =
next_pow2(d)`` (4096 at granite's width), so x is read from device memory
exactly once and the mean square and the scaling run on the same
registers. The TPU kernel's row blocks exist to fill VMEM; here one row
per program already gives thousands of programs at prefill sizes.

``triton`` is imported when the kernel is first launched, never at import:
this module is imported on machines without Triton (the CPU tests), where
:func:`repro_torch.kernels.ops.rmsnorm` takes the plain version instead.
"""
from __future__ import annotations

import threading
import time

import torch

# bound to ``triton.language`` by :func:`_jit` on the first launch; the
# kernel body below resolves ``tl`` through this module's globals when
# Triton compiles it
tl = None
_lock = threading.Lock()
_kernel = None
compile_seconds = 0.0   # first launch, Triton's compile included


def _rmsnorm_rows(x_ptr, scale_ptr, out_ptr, d, eps, BLOCK_D: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_D)
    mask = cols < d
    x = tl.load(x_ptr + row * d + cols, mask=mask, other=0.0).to(tl.float32)
    ms = tl.sum(x * x, axis=0) / d
    s = tl.load(scale_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    y = x * (1.0 / tl.sqrt(ms + eps)) * s
    tl.store(out_ptr + row * d + cols, y.to(out_ptr.dtype.element_ty),
             mask=mask)


def _jit():
    global tl, _kernel
    with _lock:
        if _kernel is None:
            import triton
            import triton.language as language
            tl = language
            _kernel = triton.jit(_rmsnorm_rows)
    return _kernel


def rmsnorm_triton(x2d: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """x2d (rows, d) contiguous CUDA tensor, scale (d,) f32 (validated by
    the caller) -> (rows, d) in x's dtype."""
    global compile_seconds
    first = _kernel is None
    t0 = time.perf_counter()
    kernel = _jit()
    rows, d = x2d.shape
    out = torch.empty_like(x2d)
    if x2d.numel():
        block = 1 << max(0, (d - 1).bit_length())
        kernel[(rows,)](x2d, scale, out, d, eps, BLOCK_D=block,
                        num_warps=min(16, max(1, block // 512)))
    if first:
        torch.cuda.synchronize(x2d.device)
        compile_seconds = time.perf_counter() - t0
    return out
