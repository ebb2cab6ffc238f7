#!/usr/bin/env python3
"""Splits a step of the f32 backward kernels B3 (dq) and B4 (dk, dv) into
its phases with ``clock64`` stamps, on one NVIDIA GPU.

    python3 bwd_stamps.py [OTHER ...]

For this checkout and each OTHER (the root of another checkout, e.g. the
parent commit unpacked under ``build/``), it writes an instrumented copy
of ``src/repro_torch/csrc/flash_attention_bwd.cu`` with the headers beside
it under ``build/stamps-<tag>/`` (tags A, B, ... for the OTHERs, the last
for this checkout; ``.gitignore`` lists ``build/``), builds that file
alone into a library and runs the f32 mma.sync kernels through this
checkout's launchers at granite's S4096 Hq32:8 D128 causal, phase 11b's
B1 S128 Hq40:8 and whisper's S1500 Hq20 D64 non-causal. Lane 0 of every
warp stamps each step's phases and adds its cycles into a device array:

* ``wait``: from the step's top to its stage's data being in (and, in a
  ring of cp.async, the block barrier and the next copy's issue);
* ``scores``: the two score products (S or S^T, dP or dP^T);
* ``softmax_ds``: p and ds from the scores, and their store to shared
  memory;
* ``barriers``: the barrier(s) around that store (the warp pair's, or the
  block's);
* ``second``: the second products (dq; or dk and dv).

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
PHASES = ("wait", "scores", "softmax_ds", "barriers", "second")
# (B, S, Hq, Hkv, D, causal)
SHAPES = ((1, 4096, 32, 8, 128, True), (1, 128, 40, 8, 128, True),
          (1, 1500, 20, 20, 64, False))

SUMS = '''
__device__ unsigned long long repro_stamp_sum[2][8];
// [kernel][phase] cycles, [6] warp-steps, [7] warps; read and cleared
extern "C" int repro_stamps(unsigned long long* out) {
  const cudaError_t e = cudaMemcpyFromSymbol(out, repro_stamp_sum, sizeof(repro_stamp_sum));
  static const unsigned long long zero[16] = {};
  cudaMemcpyToSymbol(repro_stamp_sum, zero, sizeof(zero));
  return int(e);
}
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
                                            SUMS + "\nnamespace {\n", 1)


def stamped_tree(tag: str, csrc: Path) -> Path:
    """build/stamps-<tag>/.../csrc: the instrumented backward, errors.cu
    and the headers of ``csrc``."""
    out = ROOT / "build" / f"stamps-{tag}" / "src" / "repro_torch" / "csrc"
    shutil.rmtree(out.parents[2], ignore_errors=True)
    out.mkdir(parents=True)
    for h in csrc.glob("*.cuh"):
        shutil.copy(h, out / h.name)
    shutil.copy(csrc / "errors.cu", out / "errors.cu")
    (out / BWD).write_text(instrument((csrc / BWD).read_text()))
    return out


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_dkv_cuda, flash_attention_dq_cuda)

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
        lib.repro_stamps.argtypes = [ctypes.c_void_p]
        for B, S, Hq, Hkv, D, causal in SHAPES:
            gen = torch.Generator(device=dev).manual_seed(0)
            q, do = (torch.randn(B, S, Hq, D, generator=gen, device=dev)
                     for _ in "qo")
            k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev)
                    for _ in "kv")
            o, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal)
            args = (q, k, v, do, lse, ref.attention_delta(o, do))
            kw = dict(causal=causal, window=0)
            for kern, fn in enumerate((flash_attention_dq_cuda,
                                       flash_attention_dkv_cuda)):
                fn(*args, **kw)
                torch.cuda.synchronize()
                _build.check(lib.repro_stamps(ctypes.addressof(out)), "stamps")
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    fn(*args, **kw)
                end.record()
                end.synchronize()
                _build.check(lib.repro_stamps(ctypes.addressof(out)), "stamps")
                st = list(out)[8 * kern:8 * kern + 8]
                steps = max(st[6], 1)
                cycles = {p: st[i] / steps for i, p in enumerate(PHASES)}
                total = sum(cycles.values())
                print(json.dumps({
                    "tag": tag, "tree": str(dirs[ord(tag) - 65].parents[2]),
                    "kernel": ("B3", "B4")[kern],
                    "shape": f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} "
                             + ("causal" if causal else "non-causal"),
                    "stamped_ms": start.elapsed_time(end) / 3,
                    "warp_steps": st[6] // 3, "warps": st[7] // 3,
                    "cycles_per_step": cycles,
                    "share": {p: c / total for p, c in cycles.items()}}),
                    flush=True)
            del q, k, v, do, o, lse, args
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
