"""Build and load the CUDA C++ kernels of ``repro_torch/csrc``.

Every ``*.cu`` file there is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and linked into one shared
library with a plain C interface, which :func:`library` loads with
``ctypes``. The library lands in ``build/kernels-<hash>/`` at the root of
the checkout (listed in ``.gitignore``); the hash covers the sources, the
``*.cuh`` headers beside them and the flags, so an edited kernel is
rebuilt and an unchanged one is loaded as it is. The build happens at the first launch, never at import. A
missing ``nvcc`` or a failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the ``dtype`` argument of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# C signatures of the entry points (see the extern "C" functions in csrc/)
SIGNATURES = {
    # q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, scale, dtype, stream
    "repro_flash_attention_fwd": [_VP] * 4 + [_INT] * 8 + [_FLOAT, _INT, _VP],
    # q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, D, causal, window, scale, dtype,
    # stream
    "repro_flash_attention_fwd_lse": [_VP] * 5 + [_INT] * 8
    + [_FLOAT, _INT, _VP],
    # q, k, v, do, lse, delta, dq, B, Sq, Sk, Hq, Hkv, D, causal, window,
    # scale, dtype, stream
    "repro_flash_attention_dq": [_VP] * 7 + [_INT] * 8 + [_FLOAT, _INT, _VP],
    # q, k, v, do, lse, delta, dk, dv, B, Sq, Sk, Hq, Hkv, D, causal,
    # window, scale, dtype, stream
    "repro_flash_attention_dkv": [_VP] * 8 + [_INT] * 8
    + [_FLOAT, _INT, _VP],
    # q, k_pages, v_pages, block_tables, lengths, o,
    # B, P, ps, Hq, Hkv, D, npag, scale, dtype, splits, stream
    "repro_paged_attention_fwd": [_VP] * 6 + [_INT] * 7
    + [_FLOAT, _INT, _INT, _VP],
    # q, k, v, ld, u, o, state, strides (16 int64), B, T, H, K, V, dtype,
    # ld_dtype, v_slice, stream
    "repro_wkv6_fwd": [_VP] * 8 + [_INT] * 8 + [_VP],
    # x, scale, out, rows, d, eps, dtype, threads, stream
    "repro_rmsnorm_fwd": [_VP] * 3 + [_INT] * 2 + [_FLOAT, _INT, _INT, _VP],
    # the plan queries: the launch the entry point above makes for these
    # sizes and launch parameter, written to out (6 int64: grid x, y, z,
    # threads, dynamic shared bytes, cluster x); they launch nothing.
    # B, Sq, Sk, Hq, Hkv, D, dtype, out
    "repro_flash_attention_fwd_plan": [_INT] * 7 + [_VP],
    "repro_flash_attention_dq_plan": [_INT] * 7 + [_VP],
    "repro_flash_attention_dkv_plan": [_INT] * 7 + [_VP],
    # B, P, ps, Hq, Hkv, D, npag, dtype, splits, out
    "repro_paged_attention_plan": [_INT] * 9 + [_VP],
    # B, T, H, K, V, dtype, ld_dtype, v_slice, out
    "repro_wkv6_plan": [_INT] * 8 + [_VP],
    # rows, d, dtype, aligned (x, scale, out on 16-byte boundaries), threads,
    # out
    "repro_rmsnorm_plan": [_INT] * 5 + [_VP],
    # what the card makes of a K2 launch (clusters resident at once, K2's
    # largest portable cluster), written to out (2 int64); launches
    # nothing: B, P, ps, Hq, Hkv, D, npag, dtype, splits, out
    "repro_paged_attention_clusters": [_INT] * 9 + [_VP],
    # attr, value (int*): cudaDeviceGetAttribute of the current device
    "repro_device_attribute": [_INT, _VP],
}
PLAN_FIELDS = ("grid_x", "grid_y", "grid_z", "threads", "smem", "cluster")
# what the library did in this process: built from source, loaded
BUILDS = {"built": 0, "loaded": 0}

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/"
        "bin): the CUDA kernels of repro_torch are built from source")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[Path]) -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (unless a build of
    exactly these sources exists) and return its path. The compiler's
    ``-Xptxas -v`` report (registers, shared memory, spills per kernel) is
    kept beside it in ``build.log``."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out_dir = BUILD_ROOT / f"kernels-{_digest(srcs)}"
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = nvcc_path()
    tmp = out_dir / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        procs = []
        for s in srcs:
            obj = tmp / (s.stem + ".o")
            procs.append((s, obj, subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-c", str(s), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for s, _, p in procs:
            text, _ = p.communicate()
            log.append(f"== {s.name} (exit {p.returncode})\n{text}")
            if p.returncode != 0:
                failed.append(s.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
             *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("linking the kernel library failed:\n"
                               + "\n".join(log))
        (out_dir / "build.log").write_text("\n".join(log))
        BUILDS["built"] += 1
        # rename is atomic: a concurrent build finds a whole library or none
        os.replace(tmp / LIB_NAME, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, argtypes in SIGNATURES.items():
                # a library built from an older checkout (ab_attention.py)
                # lacks the newer entry points: calling one raises
                fn = getattr(lib, name, None)
                if fn is None:
                    continue
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            BUILDS["loaded"] += 1
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def plan(name: str, *args: int) -> dict:
    """The launch ``repro_<name>_plan`` reports for ``args`` (the plan
    query of an entry point, computed by the functions its launcher
    calls): {grid_x, grid_y, grid_z, threads, smem, cluster}. Raises
    where the C code refuses the sizes or the launch parameter."""
    out = (ctypes.c_int64 * len(PLAN_FIELDS))()
    err = getattr(library(), f"repro_{name}_plan")(
        *args, ctypes.addressof(out))
    check(err, f"{name} plan")
    return dict(zip(PLAN_FIELDS, (int(v) for v in out)))


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        name = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name}) at launch")
