#!/usr/bin/env python3
"""Splits a step of the f32 flash-attention kernels into its phases with
``clock64`` stamps, on one NVIDIA GPU: the backward's B3 (dq) and B4 (dk,
dv), and the forward's K1/B2.

    python3 bwd_stamps.py [OTHER ...]

For this checkout and each OTHER (the root of another checkout, e.g. the
parent commit unpacked under ``build/``), it writes instrumented copies
of ``src/repro_torch/csrc/flash_attention_bwd.cu`` and
``flash_attention.cu`` with the headers beside them under
``build/stamps-<tag>/`` (tags A, B, ... for the OTHERs, the last for this
checkout; ``.gitignore`` lists ``build/``), builds those files alone into
a library and runs the f32 mma.sync kernels through this checkout's
launchers: B3 and B4 at granite's S4096 Hq32:8 D128 causal, phase 11b's
B1 S128 Hq40:8 and whisper's S1500 Hq20 D64 non-causal; the forward (B2,
with its lse rows) at granite's S4096, 11b's B1 S128 (where it splits the
key range over a cluster: each rank's steps) and whisper's cross
attention B1 Sq128 Sk1500 (split too). Lane 0 of every warp stamps each
step's phases and adds its cycles into a device array. The backward's:

* ``wait``: from the step's top to its stage's data being in (and, in a
  ring of cp.async, the block barrier and the next copy's issue);
* ``scores``: the two score products (S or S^T, dP or dP^T);
* ``softmax_ds``: p and ds from the scores, and their store to shared
  memory;
* ``barriers``: the barrier(s) around that store (the warp pair's, or the
  block's);
* ``second``: the second products (dq; or dk and dv).

The forward's: ``wait`` (as above, with the last step's release and
refill), ``scores`` (S = Q K^T), ``softmax`` (the mask, the running max,
p and the row sum) and ``pv`` (P V and its fold).

Each JSON line has the cycles a warp spends per step in each phase, their
shares, the warp-steps counted and the stamped run's ms (the stamps cost
time: compare shares, not ms). The stamps find their places by the
kernels' source lines (the cp.async ring of earlier checkouts or the TMA
ring) and raise where a line is missing. The first line is the card's
name and power limit. Exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import string
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BWD = "flash_attention_bwd.cu"
FWD = "flash_attention.cu"
PHASES = ("wait", "scores", "softmax_ds", "barriers", "second")
FWD_PHASES = ("wait", "scores", "softmax", "pv")
# (B, S, Hq, Hkv, D, causal)
SHAPES = ((1, 4096, 32, 8, 128, True), (1, 128, 40, 8, 128, True),
          (1, 1500, 20, 20, 64, False))
# the forward's: (B, Sq, Sk, Hq, Hkv, D, causal)
FWD_SHAPES = ((1, 4096, 4096, 32, 8, 128, True),
              (1, 128, 128, 40, 8, 128, True),
              (1, 128, 1500, 20, 20, 64, False))


def _sums(tag: str) -> str:
    """The stamps' device array of one source file and its reader,
    ``repro_stamps_<tag>``: [kernel][phase] cycles, [6] warp-steps, [7]
    warps; read and cleared."""
    return f'''
__device__ unsigned long long repro_stamp_sum[2][8];
extern "C" int repro_stamps_{tag}(unsigned long long* out) {{
  const cudaError_t e = cudaMemcpyFromSymbol(out, repro_stamp_sum, sizeof(repro_stamp_sum));
  static const unsigned long long zero[16] = {{}};
  cudaMemcpyToSymbol(repro_stamp_sum, zero, sizeof(zero));
  return int(e);
}}
'''


START = ("  unsigned long long st_acc[6] = {}; "
         "long long st_t = clock64(), st_k0 = st_t;\n")


def _stamp(i: int) -> str:
    return (f"    {{ long long st_n = clock64(); st_acc[{i}] += st_n - st_t; "
            f"st_t = st_n; }}\n")


def _flush(k: int) -> str:
    return (f"  if ((threadIdx.x & 31) == 0) {{ st_acc[5] = clock64() - st_k0; "
            f"for (int i = 0; i < 6; ++i) atomicAdd(&repro_stamp_sum[{k}][i], "
            f"st_acc[i]); atomicAdd(&repro_stamp_sum[{k}][6], "
            f"(unsigned long long)steps); atomicAdd(&repro_stamp_sum[{k}][7], "
            f"1ull); }}\n")


def _at(text: str, anchor: str, add: str, after: bool = True,
        nth: int = 0) -> str:
    """``add`` after (or before) the ``nth`` occurrence of ``anchor``."""
    idx = -1
    for _ in range(nth + 1):
        idx = text.find(anchor, idx + 1)
        if idx < 0:
            raise ValueError(f"no line {anchor!r} to stamp")
    at = idx + len(anchor) if after else idx
    return text[:at] + add + text[at:]


def instrument(src: str) -> str:
    """The backward source with B3's and B4's f32 steps stamped."""
    tma = "attn_dq_kernel(const __grid_constant__" in src
    sig = "(const __grid_constant__" if tma else "(const T*"
    a = src.index("attn_dq_kernel" + sig)
    b = src.index("attn_dkv_kernel" + sig)
    c = src.index("// ------------------------------------------- bf16 at D 64/128")
    head, dq, dkv, tail = src[:a], src[a:b], src[b:c], src[c:]
    dq = _at(dq, "  float acc[ND][4] = {};\n", START)
    dkv = _at(dkv, "  float dk_acc[ND][4] = {}, dv_acc[ND][4] = {};\n", START)
    if tma:
        top = "(step >> 1) & 1);  // this step's tiles are in\n"
        dq = _at(dq, top, _stamp(0))
        dq = _at(dq, "Vt + half * (NS / 2) * LD, lane);\n", _stamp(1))
        dq = _at(dq, "      grad_scores(std::false_type{});\n", _stamp(2))
        dq = _at(dq, "    mma::named_sync(1 + rg, 64);\n", _stamp(3))
        dq = _at(dq, "dp, lane);\n", _stamp(2))
        dq = _at(dq, "    mma::named_sync(1 + rg, 64);\n", _stamp(3), nth=1)
        dkv = _at(dkv, top, _stamp(0))
        dkv = _at(dkv, "    auto grad_scores", _stamp(1), after=False)
        dkv = _at(dkv, "      grad_scores(std::false_type{});\n", _stamp(2))
        dkv = _at(dkv, "    mma::named_sync(1 + rg, 64);\n", _stamp(3))
        dkv = _at(dkv, "half * (NS / 2), dp, lane);\n", _stamp(2))
        dkv = _at(dkv, "    mma::named_sync(1 + rg, 64);\n", _stamp(3), nth=1)
    else:
        issue = "    if (step + 1 < steps) issue(step + 1);\n"
        dq = _at(dq, issue, _stamp(0))
        dq = _at(dq, "Vt + half * (NS / 2) * LD, lane);\n", _stamp(1))
        dq = _at(dq, "dp, lane);\n", _stamp(2))
        dq = _at(dq, "    warp_ab<NS, LDP, LD>(acc", _stamp(3), after=False)
        dkv = _at(dkv, issue, _stamp(0))
        dkv = _at(dkv, "dOt + half * (NS / 2) * LD, lane);\n", _stamp(1))
        dkv = _at(dkv, "half * (NS / 2), dp, lane);\n", _stamp(2))
        dkv = _at(dkv, "    warp_ab<NS, LDP, LD>(dv_acc", _stamp(3),
                  after=False)
    dq = _at(dq, "Kt + half * (D / 2), lane);\n", _stamp(4))
    dkv = _at(dkv, "Qt + half * (D / 2), lane);\n", _stamp(4))
    dq = _at(dq, "  store_rows<D>(dq + ", _flush(0), after=False)
    dkv = _at(dkv, "  const size_t head = (size_t(b) * Sk * Hkv + hk) * D;\n",
              _flush(1), after=False)
    return (head + dq + dkv + tail).replace("namespace {\n",
                                            _sums("bwd") + "\nnamespace {\n", 1)


def instrument_fwd(src: str) -> str:
    """The forward source with its mma.sync kernel's steps stamped (kernel
    0 of its array; a split launch's ranks each stamp their own steps)."""
    a = src.index("attn_fwd_kernel(")
    b = src.index("// ------------------------------------------- bf16 at D 64/128")
    head, fwd, tail = src[:a], src[a:b], src[b:]
    fwd = _at(fwd, "  float acc[ND][4] = {};\n", START)
    if "mbar_wait(rc.full(s)" in fwd:   # the TMA ring
        fwd = _at(fwd, "  // this step's tiles are in\n", _stamp(0))
    else:
        fwd = _at(fwd, "    if (step + 1 < steps) issue(step + 1);\n", _stamp(0))
    fwd = _at(fwd, "Kt, lane);\n", _stamp(1))
    fwd = _at(fwd, "    pv<D, LD, NT", _stamp(2), after=False)
    at = fwd.index(";\n", fwd.index("    pv<D, LD, NT")) + 2   # its end
    fwd = fwd[:at] + _stamp(3) + fwd[at:]
    end = ("  if constexpr (CLUSTER) {\n" if "if constexpr (CLUSTER)" in fwd
           else "  T* oh = o + ")
    fwd = _at(fwd, end, _flush(0), after=False)
    return (head + fwd + tail).replace("namespace {\n",
                                       _sums("fwd") + "\nnamespace {\n", 1)


def stamped_tree(tag: str, csrc: Path) -> Path:
    """build/stamps-<tag>/.../csrc: the instrumented backward and forward,
    errors.cu and the headers of ``csrc``."""
    out = ROOT / "build" / f"stamps-{tag}" / "src" / "repro_torch" / "csrc"
    shutil.rmtree(out.parents[2], ignore_errors=True)
    out.mkdir(parents=True)
    for h in csrc.glob("*.cuh"):
        shutil.copy(h, out / h.name)
    shutil.copy(csrc / "errors.cu", out / "errors.cu")
    (out / BWD).write_text(instrument((csrc / BWD).read_text()))
    (out / FWD).write_text(instrument_fwd((csrc / FWD).read_text()))
    return out


def _line(tag, tree, kernel, shape, st, phases, ms):
    """One JSON line: per-step cycles and shares of ``st`` (a kernel's
    row of the device array, three stamped runs)."""
    steps = max(st[6], 1)
    cycles = {p: st[i] / steps for i, p in enumerate(phases)}
    total = sum(cycles.values())
    return json.dumps({
        "tag": tag, "tree": tree, "kernel": kernel, "shape": shape,
        "stamped_ms": ms, "warp_steps": st[6] // 3, "warps": st[7] // 3,
        "cycles_per_step": cycles,
        "share": {p: c / total for p, c in cycles.items()}})


def _stamped(fn, lib, out, reader):
    """Runs ``fn`` once to warm up, clears the stamps, then three times:
    the device array (``reader``'s) and the mean ms."""
    import torch

    from repro_torch.kernels import _build
    read = getattr(lib, reader)
    fn()
    torch.cuda.synchronize()
    _build.check(read(ctypes.addressof(out)), "stamps")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        fn()
    end.record()
    end.synchronize()
    _build.check(read(ctypes.addressof(out)), "stamps")
    return list(out), start.elapsed_time(end) / 3


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_dkv_cuda, flash_attention_dq_cuda,
        flash_attention_lse_cuda)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dirs = [Path(o).resolve() / "src" / "repro_torch" / "csrc"
            for o in argv] + [_build.CSRC]
    trees = {tag: stamped_tree(tag, d)
             for tag, d in zip(string.ascii_uppercase, dirs)}
    dev = torch.device("cuda", 0)
    out = (ctypes.c_ulonglong * 16)()
    for tag, tree in trees.items():
        _build.CSRC, _build._lib = tree, None
        lib = _build.library()
        for reader in ("repro_stamps_bwd", "repro_stamps_fwd"):
            getattr(lib, reader).argtypes = [ctypes.c_void_p]
        name = str(dirs[ord(tag) - 65].parents[2])
        for B, S, Hq, Hkv, D, causal in SHAPES:
            gen = torch.Generator(device=dev).manual_seed(0)
            q, do = (torch.randn(B, S, Hq, D, generator=gen, device=dev)
                     for _ in "qo")
            k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev)
                    for _ in "kv")
            o, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal)
            args = (q, k, v, do, lse, ref.attention_delta(o, do))
            kw = dict(causal=causal, window=0)
            shape = (f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} "
                     + ("causal" if causal else "non-causal"))
            for kern, fn in enumerate((flash_attention_dq_cuda,
                                       flash_attention_dkv_cuda)):
                st, ms = _stamped(lambda: fn(*args, **kw), lib, out,
                                  "repro_stamps_bwd")
                print(_line(tag, name, ("B3", "B4")[kern], shape,
                            st[8 * kern:8 * kern + 8], PHASES, ms),
                      flush=True)
            del q, k, v, do, o, lse, args
        for B, Sq, Sk, Hq, Hkv, D, causal in FWD_SHAPES:
            gen = torch.Generator(device=dev).manual_seed(0)
            q = torch.randn(B, Sq, Hq, D, generator=gen, device=dev)
            k, v = (torch.randn(B, Sk, Hkv, D, generator=gen, device=dev)
                    for _ in "kv")
            kw = dict(causal=causal, window=0)
            st, ms = _stamped(lambda: flash_attention_lse_cuda(q, k, v, **kw),
                              lib, out, "repro_stamps_fwd")
            shape = (f"B{B} Sq{Sq} Sk{Sk} Hq{Hq} Hkv{Hkv} D{D} "
                     + ("causal" if causal else "non-causal"))
            print(_line(tag, name, "K1/B2", shape, st[:8], FWD_PHASES, ms),
                  flush=True)
            del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
