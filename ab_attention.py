#!/usr/bin/env python3
"""Times the hand-written kernels of other checkouts against this one's on
one NVIDIA GPU, in turns.

    python3 ab_attention.py [--kernels K1,B2,B3,B4,B6,K2,K3]
                            [--dtypes float32,bfloat16] OTHER [OTHER ...]

Each OTHER is the root of a checkout (for the parent commit: ``git archive``
unpacked under ``build/``, which ``.gitignore`` lists). The kernel library is
built from each OTHER's ``src/repro_torch/csrc`` and from this checkout's
(tags A, B, ... for the OTHERs in order, the last tag for this checkout) and
called through this checkout's launchers, so the C entry points must match
(their signatures are in ``kernels/_build.py``); the libraries build at
once, one thread a tree. Cases, in f32 and bf16, one JSON line each: K1
and B2 at the shapes of ``chip_smoke.py`` phases 2 and 2b (B2 also at
phase 11b's B1, B2, B4 and B8 S128 microbatches; K1 also at phase 9's
8-token prefills, whisper's
non-causal encoder, its cross attention at Sq4 and Sq128 against Sk1500,
and llama4's prefills), B3 and B4 at the training shape, whisper's
encoder and phase 11b's B8 S128 and B1 microbatches (B4 also at B4), B6
at phase 2c's shapes, K2 and K3 at phase 2's; ``--kernels`` and
``--dtypes`` keep a subset. Each line has the device ms of
every library (a CUDA graph of back-to-back calls, ``chip_smoke._time_ms``)
and the eager call's ms (``call_ms_<tag>``: the host's cost per call where
it exceeds the device's) in the turns A B .. B A, twice each, and each
output's error against the plain version (relative to its max magnitude; K1
and K3 in bf16 also in units of bf16 rounding, ``chip_smoke._ulp_err``), and
``max_abs_delta_<tag>``: the largest |difference| between that tag's
outputs and the first tag's on the same inputs (0: the same bits).
Where an OTHER's K3 is its Triton kernel
(``kernels/rmsnorm.py::rmsnorm_triton``, before it was rewritten in CUDA
C++), that kernel runs in its turns; K3's lines also time ``F.rms_norm`` and
a one-element in-place add (the floor under any one-kernel call), twice
each, after the turns. The first line is the card's name and power limit.
Exits non-zero without a card.
"""
from __future__ import annotations

import importlib.util
import json
import string
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# K3 per tag: the launcher that runs in that tag's turns, and the tag whose
# turn it is (set by main before each call)
K3_IMPL: dict = {}
TURN = [""]


def main(argv: list[str]) -> int:
    import torch
    import torch.nn.functional as F
    kernels, dtypes = ALL, DTYPES
    while argv[:1] in (["--kernels"], ["--dtypes"]) and len(argv) > 1:
        if argv[0] == "--kernels":
            kernels = argv[1].split(",")
        else:
            dtypes = argv[1].split(",")
        argv = argv[2:]
    others = argv
    if (not others or not torch.cuda.is_available()
            or set(kernels) - set(ALL) or set(dtypes) - set(DTYPES)):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as c
    from repro_torch.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    tree = _build.CSRC
    dirs = [Path(o).resolve() / "src" / "repro_torch" / "csrc"
            for o in others] + [tree]
    tags = string.ascii_uppercase[:len(dirs)]
    # every tree's library at once (each build runs one nvcc per source)
    with ThreadPoolExecutor(len(dirs)) as pool:
        list(pool.map(_build.build_library, dirs))
    libs = {}
    for tag, d in zip(tags, dirs):
        _build.CSRC, _build._lib = d, None
        libs[tag] = _build.library()
        K3_IMPL[tag] = _k3_launcher(d.parent / "kernels" / "rmsnorm.py", tag)
    _build.CSRC = tree
    turns = tags + tags[::-1]

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    for dname in dtypes:
        dtype = getattr(torch, dname)
        for fn, shape, call, want in _cases(kernels, dtype, dev, gen):
            line = {"kernel": fn, "dtype": dname, "shape": shape}
            first = {}   # each tag's outputs in its first turn
            for tag in turns:
                _build._lib, TURN[0] = libs[tag], tag
                got = call()
                first.setdefault(tag, [g.detach().clone() for g in got])
                if tag != tags[0]:
                    line[f"max_abs_delta_{tag}"] = max(
                        float((g.float() - a.float()).abs().max())
                        for g, a in zip(got, first[tags[0]]))
                line[f"rel_err_{tag}"] = max(
                    c._err(g, w) / max(float(w.float().abs().max()), 1e-30)
                    for g, w in zip(got, want))
                if fn in ("K1", "K3") and dname == "bfloat16":
                    line[f"max_ulp_err_{tag}"] = c._ulp_err(got[0], want[0])
                dev_ms, call_ms = c._time_ms(call)
                line.setdefault(f"ms_{tag}", []).append(dev_ms)
                line.setdefault(f"call_ms_{tag}", []).append(call_ms)
            _build._lib, TURN[0] = libs[tags[-1]], tags[-1]
            if fn == "K3":
                x, scale = call.inputs
                lib_scale = scale.to(dtype)
                one = torch.zeros(1, device=dev)
                line["ms_rms_norm"] = [c._time_ms(lambda: F.rms_norm(
                    x, (x.shape[-1],), weight=lib_scale, eps=1e-5))[0]
                    for _ in range(2)]
                line["ms_floor"] = [c._time_ms(lambda: one.add_(1.0))[0]
                                    for _ in range(2)]
            print(json.dumps(line), flush=True)
            del call, want, got, first
            torch.cuda.empty_cache()
    return 0


ALL = ["K1", "B2", "B3", "B4", "B6", "K2", "K3"]
DTYPES = ["float32", "bfloat16"]


def _k3_launcher(module: Path, tag: str):
    """The K3 launcher of a checkout: its Triton kernel where its
    ``kernels/rmsnorm.py`` still defines one (loaded from that file), else
    this checkout's CUDA launcher, which calls whatever library is swapped
    in for the turn."""
    if "def rmsnorm_triton" in module.read_text():
        spec = importlib.util.spec_from_file_location(f"ab_k3_{tag}", module)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.rmsnorm_triton
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    return rmsnorm_cuda


class _Call:
    """A case's call, with the inputs the K3 lines time the library on."""

    def __init__(self, fn, *inputs):
        self.fn, self.inputs = fn, inputs

    def __call__(self):
        return self.fn()


def _cases(kernels, dtype, dev, gen):
    """(kernel, shape, call, plain outputs) per case, lazily: the flash
    kernels, then B6, K2 and K3."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_dkv_cuda,
        flash_attention_dq_cuda, flash_attention_lse_cuda)
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels.wkv6 import wkv6_cuda

    def rand(*shape, f32=False):
        x = torch.randn(shape, generator=gen, device=dev)
        return x if f32 else x.to(dtype)

    # (kernel, B, Sq, Sk, Hq, Hkv, D, window, causal), Sk None for Sq:
    # phase 2b's B2, and at phase 11b's B1, B2, B4 and B8 S128 microbatches
    # (qwen2.5's GQA 40:8; where the grid underfills the card, f32 K1/B2
    # split the key range over a cluster); phase 2's K1 (granite, and
    # phase 9's 8-token prefills of 1 and 4 prompts; hymba;
    # whisper's encoder, non-causal, and its cross attention at Sq4 and
    # Sq128 against Sk1500; llama4's prefills), B3 and B4 at the training
    # shape, whisper's encoder and phase 11b's B8 and B1 S128 microbatches
    # (at B1, and at B4's B4, f32 B4 splits its group over a cluster)
    flash = [("B2", 1, 4096, None, 32, 8, 128, 0, True),
             ("B2", 1, 4000, None, 32, 8, 128, 0, True),
             ("B2", 1, 128, None, 40, 8, 128, 0, True),
             ("B2", 2, 128, None, 40, 8, 128, 0, True),
             ("B2", 4, 128, None, 40, 8, 128, 0, True),
             ("B2", 8, 128, None, 40, 8, 128, 0, True),
             ("K1", 1, 128, None, 32, 8, 128, 0, True),
             ("K1", 1, 125, None, 32, 8, 128, 0, True),
             ("K1", 1, 8, None, 32, 8, 128, 0, True),
             ("K1", 4, 8, None, 32, 8, 128, 0, True),
             ("K1", 1, 2048, None, 32, 8, 128, 0, True),
             ("K1", 1, 128, None, 25, 5, 64, 1024, True),
             ("K1", 1, 1100, None, 25, 5, 64, 1024, True),
             ("K1", 1, 1500, None, 20, 20, 64, 0, False),
             ("K1", 4, 4, 1500, 20, 20, 64, 0, False),
             ("K1", 1, 128, 1500, 20, 20, 64, 0, False),
             ("K1", 1, 128, None, 40, 8, 128, 0, True),
             ("K1", 1, 125, None, 40, 8, 128, 0, True),
             ("B3", 1, 4096, None, 32, 8, 128, 0, True),
             ("B3", 1, 1500, None, 20, 20, 64, 0, False),
             ("B3", 8, 128, None, 40, 8, 128, 0, True),
             ("B3", 1, 128, None, 40, 8, 128, 0, True),
             ("B4", 1, 4096, None, 32, 8, 128, 0, True),
             ("B4", 1, 1500, None, 20, 20, 64, 0, False),
             ("B4", 8, 128, None, 40, 8, 128, 0, True),
             ("B4", 4, 128, None, 40, 8, 128, 0, True),
             ("B4", 1, 128, None, 40, 8, 128, 0, True)]
    for fn, B, Sq, Sk, Hq, Hkv, D, W, causal in flash:
        if fn not in kernels:
            continue
        Sk = Sq if Sk is None else Sk
        q, do = rand(B, Sq, Hq, D), rand(B, Sq, Hq, D)
        k, v = rand(B, Sk, Hkv, D), rand(B, Sk, Hkv, D)
        kw = dict(causal=causal, window=W)
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
        yield (fn, f"B{B} " + (f"S{Sq}" if Sk == Sq else f"Sq{Sq} Sk{Sk}")
               + f" Hq{Hq} Hkv{Hkv} D{D} "
               + ("causal" if causal else "non-causal")
               + (f" window{W}" if W else ""), call, want())
    if "B6" in kernels:
        # phase 2c's cases: (mode, T, H, K, decay)
        for mode, T, H, K, decay in (
                ("rwkv6", 128, 40, 64, "mild"), ("rwkv6", 125, 40, 64, "mild"),
                ("ssd", 128, 25, 16, "per_head"),
                ("ssd", 1100, 25, 16, "per_head"),
                ("rwkv6", 4096, 40, 64, "mild"),
                ("rwkv6", 4096, 40, 64, "strong")):
            V = 64
            q, k, v = rand(1, T, H, K), rand(1, T, H, K), rand(1, T, H, V)
            if decay == "mild":
                ld = -torch.exp(-6.0 + 0.5 * rand(1, T, H, K, f32=True))
            elif decay == "strong":
                ld = -torch.exp(rand(1, T, H, K, f32=True))
            else:
                ld = (-F.softplus(rand(1, T, H, 1, f32=True))).expand(
                    1, T, H, K)
            ld = ld.clamp(-12.0, -1e-4) if decay != "per_head" else ld
            u = 0.1 * rand(H, K, f32=True) if mode == "rwkv6" else None
            yield ("B6", f"B1 T{T} H{H} K{K} V{V} {mode} {decay}",
                   lambda: wkv6_cuda(q, k, v, ld, u),
                   ref.wkv6_chunked_ref(q, k, v, ld, u))
    if "K2" in kernels:
        # phase 2's cases: (B, ctx, table width)
        for B, ctx, npag in ((4, 160, 10), (4, 4096, 256), (1, 160, 256),
                             (4, 160, 256)):
            Hq, Hkv, D, ps = 32, 8, 128, 16
            P = B * npag + 1
            q = rand(B, 1, Hq, D)
            kp, vp = rand(P, ps, Hkv, D), rand(P, ps, Hkv, D)
            bt = (torch.randperm(P - 1, generator=gen, device=dev) + 1
                  ).reshape(B, npag).to(torch.int32).contiguous()
            lens = torch.tensor([ctx, ctx - 1, ctx - 5, ctx - 15][:B],
                                dtype=torch.int32, device=dev)
            yield ("K2", f"B{B} ctx{ctx} table{npag} ps{ps} Hq{Hq} Hkv{Hkv} "
                   f"D{D}",
                   lambda: (paged_attention_cuda(q, kp, vp, bt, lens),),
                   (ref.paged_decode_attention_ref(q.float(), kp.float(),
                                                   vp.float(), bt, lens),))
    if "K3" in kernels:
        # phase 2's shapes: decode, prefill and a training microbatch
        for rows, d in ((4, 4096), (4, 1600), (128, 4096), (512, 4096),
                        (128, 1600), (1100, 1600), (4096, 4096)):
            x, scale = rand(rows, d), rand(d, f32=True)
            yield ("K3", f"rows{rows} d{d}",
                   _Call(lambda: (K3_IMPL[TURN[0]](x, scale, 1e-5),),
                         x, scale),
                   (ref.rmsnorm_ref(x.float(), scale),))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
