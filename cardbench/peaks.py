"""The table of peaks that every share is divided by, and the card's
power limit printed beside it.

NVIDIA H100 SXM5 80 GB, dense rates without sparsity, from NVIDIA's data
sheet: 989 TFLOP/s for bf16 inputs, 495 TFLOP/s for f32 inputs on the
tensor cores (TF32), 3.35 TB/s of HBM3. f32 takes the TF32 rate and not
the 67 TFLOP/s of the FMA units: the port computes its f32 attention
products on tensor cores as 3xTF32, so a sound kernel could pass the FMA
rate without leaving f32 accuracy. The rates assume the full 700 W.
"""
from __future__ import annotations

import shutil
import subprocess

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def peak_flops(dtype: str) -> float:
    return PEAK_FLOPS[dtype]


def bound_s(flops: float, nbytes: float, dtype: str) -> tuple:
    """(the least seconds the card could take, "ops" or "bytes": which of
    the two terms bounds it)."""
    t_ops, t_bytes = flops / peak_flops(dtype), nbytes / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi exit {out.returncode}"
