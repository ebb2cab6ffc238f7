#!/usr/bin/env python3
"""Times the flash-attention kernels of other checkouts against this one's
on one NVIDIA GPU, in turns.

    python3 ab_attention.py OTHER [OTHER ...]

Each OTHER is the root of a checkout (for the parent commit: ``git archive``
unpacked under ``build/``, which ``.gitignore`` lists). The kernel library is
built from each OTHER's ``src/repro_torch/csrc`` and from this checkout's
(tags A, B, ... for the OTHERs in order, the last tag for this checkout) and
called through this checkout's launchers, so the C entry points must match.
For K1 and B2 at the shapes of ``chip_smoke.py`` phases 2 and 2b, and B3 and
B4 at the training shape, in f32 and bf16, one JSON line each: the device ms
of every library (a CUDA graph of back-to-back calls,
``chip_smoke._time_ms``) in the turns A B .. B A, twice each, and each
output's error against the plain version (relative to its max magnitude; K1
in bf16 also in units of bf16 rounding, ``chip_smoke._ulp_err``). The first
line is the card's name and power limit. Exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import json
import string
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main(others: list[str]) -> int:
    import torch
    if not others or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as c
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_dkv_cuda,
        flash_attention_dq_cuda, flash_attention_lse_cuda)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    tree = _build.CSRC
    dirs = [Path(o).resolve() / "src" / "repro_torch" / "csrc"
            for o in others] + [tree]
    tags = string.ascii_uppercase[:len(dirs)]
    libs = {}
    for tag, d in zip(tags, dirs):
        _build.CSRC, _build._lib = d, None
        libs[tag] = _build.library()
    _build.CSRC = tree
    turns = tags + tags[::-1]

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [("B2", 4096, 32, 8, 128, 0), ("B2", 4000, 32, 8, 128, 0),
             ("K1", 128, 32, 8, 128, 0), ("K1", 125, 32, 8, 128, 0),
             ("K1", 2048, 32, 8, 128, 0), ("K1", 128, 25, 5, 64, 1024),
             ("K1", 1100, 25, 5, 64, 1024), ("B3", 4096, 32, 8, 128, 0),
             ("B4", 4096, 32, 8, 128, 0)]
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for fn, S, Hq, Hkv, D, W in cases:
            q, do = (torch.randn((1, S, Hq, D), generator=gen, device=dev)
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn((1, S, Hkv, D), generator=gen, device=dev)
                    .to(dtype) for _ in range(2))
            kw = dict(causal=True, window=W)
            o_ref, lse_ref = ref.flash_attention_lse_ref(q, k, v, **kw)
            delta = ref.attention_delta(o_ref, do)
            args = (q, k, v, do, lse_ref, delta)
            call, want = {
                "K1": (lambda: (flash_attention_cuda(q, k, v, **kw),),
                       lambda: (ref.flash_attention_ref(
                           q.float(), k.float(), v.float(), **kw),)),
                "B2": (lambda: flash_attention_lse_cuda(q, k, v, **kw),
                       lambda: (o_ref, lse_ref)),
                "B3": (lambda: (flash_attention_dq_cuda(*args, **kw),),
                       lambda: (ref.flash_attention_dq_ref(*args, **kw),)),
                "B4": (lambda: flash_attention_dkv_cuda(*args, **kw),
                       lambda: ref.flash_attention_dkv_ref(*args, **kw)),
            }[fn]
            want = want()
            line = {"kernel": fn, "dtype": dname,
                    "shape": f"B1 S{S} Hq{Hq} Hkv{Hkv} D{D} causal"
                             + (f" window{W}" if W else "")}
            for tag in turns:
                _build._lib = libs[tag]
                got = call()
                line[f"rel_err_{tag}"] = max(
                    c._err(g, w) / max(float(w.float().abs().max()), 1e-30)
                    for g, w in zip(got, want))
                if fn == "K1" and dname == "bfloat16":
                    line[f"max_ulp_err_{tag}"] = c._ulp_err(got[0], want[0])
                line.setdefault(f"ms_{tag}", []).append(c._time_ms(call)[0])
            _build._lib = libs[tags[-1]]
            print(json.dumps(line), flush=True)
            del q, k, v, do, o_ref, lse_ref, delta, args, want
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
