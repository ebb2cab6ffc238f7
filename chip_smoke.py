#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it puts ``src`` on ``sys.path`` itself,
builds the CUDA kernels and the Triton kernel from the checkout's sources,
and needs one card. Phases, one JSON line each:

1. device: the card's name and power limit (``nvidia-smi``), the build
   time of the CUDA library and the Triton compile time;
2. kernels against their plain PyTorch versions at the shapes of the
   serving path, in f32 (tolerance 5e-4) and bf16 (2e-2): max abs error,
   the device time of the kernel, of the plain version and of one library
   call where PyTorch has one (each from a CUDA graph of back-to-back
   calls), the kernel's eager call time (host included), and the bound
   (the larger of operations over the card's peak rate for the input type
   and bytes over 3.35 TB/s);
2b. the training path's attention kernels (B2 forward with lse, B3 dq,
   B4 dk/dv) through their wrapper as training calls it (q, k, v that
   require grad through ``ops.flash_attention``, then
   ``torch.autograd.grad``; one launch of each) against their plain
   versions on the same inputs at the training shape (B1 S4096 Hq32 Hkv8
   D128 causal) and a ragged length (S4000), in f32 and bf16: max abs
   error and that error over the plain result's max magnitude (tolerance
   5e-4 f32, 2e-2 bf16, on the relative error), times and bounds as in
   phase 2; PyTorch has no call that computes dq or dk/dv alone, so the
   line also gives SDPA's forward plus backward beside B2 + B3 + B4;
3. serving at full width and full depth: granite-3-8b, 40 layers, f32,
   random weights from a seeded ``torch.Generator``, through the port's
   ``build_engine`` for the continuous and the paged scheduler on one
   workload, with each kernel's launch count over each run;
4. parity: per-request greedy tokens of the two engines are identical;
   full-width prefill logits through the kernels agree with the plain
   attention path;
5. profile: each engine serves the same workload again under
   ``torch.profiler`` (``repro_torch.core.profile``): launches per
   forward pass, the device's busy share, device time by kernel group,
   copies and synchronisations;
6. train: granite-3-8b at full width cut to 8 layers (f32 params,
   gradients, master copy and AdamW moments of 40 layers do not fit one
   80 GB card). First (6a) the gradient of every parameter leaf at the
   seeded params on step 0's first microbatch, through the kernels and
   through the plain attention path: each leaf within 1e-4 relative in L2
   norm. Then 3 steps of 2 x 4096 tokens in 2 microbatches with remat,
   through ``build_train_step`` and ``train_loop.run``, on the kernels;
   per step loss, grad_norm, seconds, tokens/s and each kernel's
   launches, and the peak memory. Then the same 3 steps from the same
   seeded params and batches on the plain attention path: per-step loss
   and grad_norm within 1e-5 (relative) of the kernel run.
   One more kernel step, after the counts are read, runs under
   ``torch.profiler`` (device time by kernel group, busy share);
7. the ``kernels`` summary line, with the launch counts of the serving
   (phase 3) and training (phase 6) runs.

Any failure raises and exits non-zero. Without a CUDA device, or outside a
checkout, it exits non-zero before printing any result. The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH = "granite-3-8b"
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 3, 2, 4096
TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-5}   # relative, kernel vs plain
GRAD_TOL = 1e-4   # per leaf, |g_kernel - g_plain| / |g_plain| (L2 norms)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12
TOL = {"float32": 5e-4, "bfloat16": 2e-2}
KERNELS = {
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:40"),
    "flash_attention_lse": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:97"),
    "flash_attention_dq": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:183"),
    "flash_attention_dkv": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:225"),
    "paged_attention": dict(
        route="cuda", source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:46"),
    "rmsnorm": dict(
        route="triton", source="src/repro_torch/kernels/rmsnorm.py",
        replaces="src/repro/kernels/rmsnorm.py:19"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this "
              "smoke test needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import rmsnorm as k3

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------ 1 device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    build_s = time.perf_counter() - t0
    _build.library()
    ptxas = _ptxas_summary(lib_path.parent / "build.log")
    x = torch.ones(4, 4096, device=dev)
    ops.rmsnorm(x, torch.ones(4096, device=dev))
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "triton": _triton_version(),
          "cuda_library_build_s": build_s,
          "triton_compile_s": k3.compile_seconds, "ptxas": ptxas})

    # ----------------------------------------------------------- 2 kernels
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    summary = {}   # kernel -> its f32 line at the serving path's shape
    failures = []

    def record(line, main_path):
        # the training kernels are held to an error relative to the plain
        # result's largest magnitude, and to one launch each through their
        # wrapper; the others to an absolute error
        line["ok"] = (line.get("rel_err", line["max_abs_err"]) <= line["tol"]
                      and line.get("launches_in_one_call", 1) == 1)
        emit(line)
        if not line["ok"]:
            failures.append(line)
        if main_path:
            summary[line["kernel"]] = line

    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        isz = torch.finfo(dtype).bits // 8
        # K1: one-shot prefill, granite's GQA 32:8 at head dim 128
        for S in (128, 125, 2048):
            B, Hq, Hkv, D = 1, 32, 8, 128
            q, k, v = (rand((B, S, h, D), dtype) for h in (Hq, Hkv, Hkv))
            out = ops.flash_attention(q, k, v, causal=True)
            want = ref.flash_attention_ref(q, k, v, causal=True)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            pairs = S * (S + 1) // 2
            b_ms, b_by = bound(4 * B * Hq * D * pairs,
                               isz * B * S * D * (2 * Hq + 2 * Hkv), dname)
            record({
                "phase": "kernel", "kernel": "flash_attention",
                "shape": f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} causal",
                "dtype": dname, "max_abs_err": _err(out, want),
                "tol": TOL[dname],
                **_times(lambda: ops.flash_attention(q, k, v, causal=True),
                         lambda: ref.flash_attention_ref(q, k, v, causal=True),
                         lambda: F.scaled_dot_product_attention(
                             qt, kt, vt, is_causal=True, enable_gqa=True)),
                "library": "scaled_dot_product_attention(enable_gqa=True)",
                "bound_ms": b_ms, "bound_by": b_by},
                main_path=(S == 128 and dname == "float32"))
        # K2: paged decode, 4 rows, 16-token pages in shuffled order
        for ctx in (160, 4096):
            B, Hq, Hkv, D, ps = 4, 32, 8, 128, 16
            npag = -(-ctx // ps)
            P = B * npag + 1
            q = rand((B, 1, Hq, D), dtype)
            kp, vp = rand((P, ps, Hkv, D), dtype), rand((P, ps, Hkv, D), dtype)
            perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
            bt = perm.reshape(B, npag).to(torch.int32).contiguous()
            lens = torch.tensor([ctx, ctx - 1, ctx - 5, ctx - 15],
                                dtype=torch.int32, device=dev)
            out = ops.paged_attention(q, kp, vp, bt, lens)
            want = ref.paged_decode_attention_ref(q, kp, vp, bt, lens)
            ntok = int(lens.sum())
            b_ms, b_by = bound(
                4 * Hq * D * ntok,
                isz * (2 * ntok * Hkv * D + 2 * B * Hq * D) + 4 * (B * npag + B),
                dname)
            record({
                "phase": "kernel", "kernel": "paged_attention",
                "shape": f"B{B} ctx{ctx} ps{ps} Hq{Hq} Hkv{Hkv} D{D}",
                "dtype": dname, "max_abs_err": _err(out, want),
                "tol": TOL[dname],
                **_times(lambda: ops.paged_attention(q, kp, vp, bt, lens),
                         lambda: ref.paged_decode_attention_ref(
                             q, kp, vp, bt, lens),
                         None),
                "library": "none: no single PyTorch call",
                "bound_ms": b_ms, "bound_by": b_by},
                main_path=(ctx == 160 and dname == "float32"))
        # K3: RMSNorm at granite's width (128 rows = one prompt's prefill)
        for rows in (128, 512):
            d = 4096
            x = rand((rows, d), dtype)
            scale = rand((d,), torch.float32)
            scale_lib = scale.to(dtype)
            out = ops.rmsnorm(x, scale)
            want = ref.rmsnorm_ref(x, scale)
            b_ms, b_by = bound(4 * rows * d, 2 * isz * rows * d + 4 * d, dname)
            record({
                "phase": "kernel", "kernel": "rmsnorm",
                "shape": f"rows{rows} d{d}", "dtype": dname,
                "max_abs_err": _err(out, want), "tol": TOL[dname],
                **_times(lambda: ops.rmsnorm(x, scale),
                         lambda: ref.rmsnorm_ref(x, scale),
                         lambda: F.rms_norm(x, (d,), weight=scale_lib,
                                            eps=1e-5)),
                "library": "rms_norm", "bound_ms": b_ms, "bound_by": b_by},
                main_path=(rows == 128 and dname == "float32"))
    _train_kernels(rand, record)
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{[(f['kernel'], f['shape'], f['dtype']) for f in failures]}")

    launches = _serve(dev)     # phases 3 to 5; frees the served model
    gc.collect()
    torch.cuda.empty_cache()
    launches["train"] = _train(dev)   # phase 6

    # ----------------------------------------------------------- 7 kernels
    total = {k: sum(launches[e][k] for e in launches) for k in KERNELS}
    need = {"flash_attention": launches["continuous"]["flash_attention"],
            "paged_attention": launches["paged"]["paged_attention"],
            **{k: launches["train"][k] for k in (
                "flash_attention_lse", "flash_attention_dq",
                "flash_attention_dkv")},
            "rmsnorm": min(launches[e]["rmsnorm"] for e in launches)}
    line = {"kernels": [
        {"name": name, **meta, "launches": total[name],
         "max_abs_err": summary[name]["max_abs_err"],
         "ms": summary[name]["kernel_ms"],
         "plain_ms": summary[name]["plain_ms"],
         "bound_ms": summary[name]["bound_ms"],
         "bound_by": summary[name]["bound_by"],
         "library_ms": summary[name]["library_ms"]}
        for name, meta in KERNELS.items()]}
    print(json.dumps(line), flush=True)
    missing = [k for k, n in need.items() if n <= 0]
    if missing:
        raise AssertionError(f"the serving or training path never launched "
                             f"{missing}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _serve(dev) -> dict:
    """Phases 3 to 5: serve full-width granite-3-8b through the continuous
    and the paged engine, check parity, profile. Returns each engine's
    launch counts; the model, engines and caches go with its frame."""
    import torch

    from repro_torch.kernels import ops

    # ------------------------------------------------------------- 3 serve
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import synth_requests
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import Runtime, build

    cfg = get_arch(ARCH)
    model = build(cfg, Runtime(attention_backend="kernel"), device=dev)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    emit({"phase": "weights", "arch": ARCH, "layers": cfg.num_layers,
          "params": sum(t.numel() for t in leaves), "dtype": "float32",
          "bytes": sum(t.numel() * t.element_size() for t in leaves),
          "init_s": time.perf_counter() - t0})

    prompt_len, budget_max = 128, 32
    reqs = synth_requests(cfg, 8, prompt_len, max_new_tokens=(2, budget_max))
    short = synth_requests(cfg, 4, prompt_len - 3, max_new_tokens=5, seed=1)
    for r in short:
        r.rid += 100
    reqs += short
    common = dict(batch=4, prompt_len=prompt_len, max_new_tokens=budget_max,
                  use_reduced=False, params=params, device=dev)
    engines = {
        "continuous": build_engine(ARCH, scheduler="continuous", **common)[0],
        "paged": build_engine(ARCH, scheduler="paged", page_size=16,
                              prefill_chunk_tokens=64, **common)[0],
    }
    reports, launches = {}, {}
    for name, eng in engines.items():
        eng.warmup(prompt_len)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        reports[name] = eng.run(reqs)
        launches[name] = dict(ops.LAUNCHES)
        s = reports[name].summary()
        emit({"phase": "serve", "scheduler": name,
              "requests": len(reqs), "lanes": eng.slots,
              **{k: s[k] for k in (
                  "completed", "total_new_tokens", "makespan_s",
                  "goodput_rps", "goodput_tps", "decode_steps", "prefills",
                  "ttft_p50_s", "ttft_p95_s", "tok_p50_s", "tok_p95_s",
                  "peak_concurrency")},
              "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
              "launches": launches[name]})
        if s["completed"] != len(reqs):
            raise AssertionError(f"{name}: {s['completed']}/{len(reqs)} "
                                 "requests completed")

    # ------------------------------------------------------------ 4 parity
    toks = {name: {m.rid: [int(t) for t in m.tokens] for m in rep.metrics}
            for name, rep in reports.items()}
    budget = {r.rid: r.max_new_tokens for r in reqs}
    for name, tk in toks.items():
        for rid, seq in tk.items():
            if len(seq) != budget[rid] or not all(
                    0 <= t < cfg.vocab_size for t in seq):
                raise AssertionError(f"{name} rid {rid}: bad tokens {seq}")
    mismatch = _first_mismatch(toks["continuous"], toks["paged"])
    dense = build(cfg, Runtime(attention_backend="dense"), device=dev)
    prompt = torch.as_tensor(reqs[0].prompt[None], device=dev)
    lk, _ = model.prefill(params, {"tokens": prompt}, prompt_len)
    ld, _ = dense.prefill(params, {"tokens": prompt}, prompt_len)
    logit_err = _err(lk, ld)
    parity = {"phase": "parity", "rids": len(toks["paged"]),
              "tokens_identical": mismatch is None,
              "prefill_logits_shape": list(lk.shape),
              "prefill_logits_finite": bool(torch.isfinite(lk).all()),
              "kernel_vs_dense_prefill_max_abs_err": logit_err,
              "tol": 1e-3}
    if mismatch is not None:
        rid, step = mismatch
        req = next(r for r in reqs if r.rid == rid)
        seq = list(req.prompt) + toks["continuous"][rid][:step]
        lg, _ = dense.prefill(params, {"tokens": torch.as_tensor(
            [seq], dtype=torch.int32, device=dev)}, len(seq))
        top2 = torch.topk(lg[0, -1], 2).values
        parity.update(first_mismatch_rid=rid, first_mismatch_step=step,
                      top2_margin=float(top2[0] - top2[1]))
    emit(parity)
    if mismatch is not None:
        raise AssertionError(f"greedy tokens differ between engines: {parity}")
    if not parity["prefill_logits_finite"] or logit_err > parity["tol"]:
        raise AssertionError(f"full-width prefill check failed: {parity}")

    # ----------------------------------------------------------- 5 profile
    from repro_torch.core.profile import profile_run
    for name, eng in engines.items():
        emit({"phase": "profile", **profile_run(eng, reqs)})
    return launches


def _train_kernels(rand, record) -> None:
    """Phase 2b: kernels B2 (forward with lse), B3 (dq) and B4 (dk, dv)
    through their wrapper as the training path calls it: q, k and v that
    require grad go through ``ops.flash_attention`` (B2, with the lse rows
    it saves for the backward) and ``torch.autograd.grad`` of its output
    (B3 and B4, on the delta of the kernel's own o), each launched exactly
    once. o, lse, dq, dk and dv are held against the plain versions on the
    same inputs. Times are of the launchers alone, B3 and B4 reading the
    plain forward's lse and delta = rowsum(dO * O). Bounds count the
    causal (q, k) pairs these inputs need, S (S + 1) / 2 per head: 2, 3
    and 4 products of D multiply-adds each (QK^T and PV; + dO V^T and
    ds K; + p^T dO and ds^T q), and every input read and output written
    once."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_dkv_cuda, flash_attention_dq_cuda,
        flash_attention_lse_cuda)

    B, Hq, Hkv, D = 1, 32, 8, 128
    kw = dict(causal=True, window=0)
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        isz = torch.finfo(dtype).bits // 8
        for S in (TRAIN_SEQ, 4000):
            q, do = rand((B, S, Hq, D), dtype), rand((B, S, Hq, D), dtype)
            k, v = rand((B, S, Hkv, D), dtype), rand((B, S, Hkv, D), dtype)
            # the wrapper, differentiated as the training step does
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            before = dict(ops.LAUNCHES)
            o = ops.flash_attention(*leaves, **kw)
            lse = o.grad_fn.saved_tensors[4]    # the rows B2 saved
            dq, dk, dv = torch.autograd.grad(o, leaves, do)
            torch.cuda.synchronize()
            rose = {n: ops.LAUNCHES[n] - before[n] for n in ops.KERNELS}
            o, lse = o.detach(), lse.clone()
            del leaves
            o_ref, lse_ref = ref.flash_attention_lse_ref(q, k, v, **kw)
            delta = ref.attention_delta(o_ref, do)
            held = {
                "flash_attention_lse": ((o, lse), (o_ref, lse_ref)),
                "flash_attention_dq": ((dq,), (ref.flash_attention_dq_ref(
                    q, k, v, do, lse_ref, delta, **kw),)),
                "flash_attention_dkv": ((dk, dv), ref.flash_attention_dkv_ref(
                    q, k, v, do, lse_ref, delta, **kw)),
            }
            args = (q, k, v, do, lse_ref, delta)
            pairs = B * Hq * S * (S + 1) // 2
            rows = 4 * B * Hq * S                      # lse or delta, f32
            qkv_bytes = isz * B * S * D * (Hq + 2 * Hkv)
            cases = {
                "flash_attention_lse": (
                    lambda: flash_attention_lse_cuda(q, k, v, **kw),
                    lambda: ref.flash_attention_lse_ref(q, k, v, **kw),
                    4 * D * pairs,
                    qkv_bytes + isz * B * S * Hq * D + rows),
                "flash_attention_dq": (
                    lambda: flash_attention_dq_cuda(*args, **kw),
                    lambda: ref.flash_attention_dq_ref(*args, **kw),
                    6 * D * pairs,
                    qkv_bytes + 2 * isz * B * S * Hq * D + 2 * rows),
                "flash_attention_dkv": (
                    lambda: flash_attention_dkv_cuda(*args, **kw),
                    lambda: ref.flash_attention_dkv_ref(*args, **kw),
                    8 * D * pairs,
                    qkv_bytes + isz * B * S * (Hq * D + 2 * Hkv * D)
                    + 2 * rows),
            }
            shape = f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} causal"
            group_ms = 0.0
            for name, (kernel, plain, flops, nbytes) in cases.items():
                got, want = held[name]
                errs = [_err(g, w) for g, w in zip(got, want)]
                rel = max(e / max(float(w.float().abs().max()), 1e-30)
                          for e, w in zip(errs, want))
                b_ms, b_by = bound(flops, nbytes, dname)
                times = _times(kernel, plain, None)
                group_ms += times["kernel_ms"]
                line = {
                    "phase": "train_kernel", "kernel": name, "shape": shape,
                    "dtype": dname, "via": "ops.flash_attention + "
                                           "torch.autograd.grad",
                    "launches_in_one_call": rose[name],
                    "max_abs_err": max(errs),
                    "rel_err": rel, "tol": TOL[dname], **times,
                    "library": "none: no single PyTorch call",
                    "bound_ms": b_ms, "bound_by": b_by}
                record(line, main_path=(S == TRAIN_SEQ
                                        and dname == "float32"))
            if rose["flash_attention"]:
                raise AssertionError(f"the differentiated wrapper launched "
                                     f"K1: {rose} at {shape} {dname}")
            del held, o, lse, dq, dk, dv
            # SDPA forward + backward: the nearest library yardstick
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True)
                torch.autograd.grad(o, (qt, kt, vt), dot)

            emit({"phase": "train_kernel_group", "shape": shape,
                  "dtype": dname, "b2_b3_b4_ms": group_ms,
                  "sdpa_fwd_bwd_ms": _eager_ms(sdpa_fwd_bwd),
                  "library": "scaled_dot_product_attention(enable_gqa=True) "
                             "forward + backward, eager"})
            del q, k, v, do, o_ref, lse_ref, delta, args, cases, qt, kt, vt
            torch.cuda.empty_cache()


def _train_config(backend: str):
    """The training phase's RunConfig: full-width granite-3-8b cut to
    TRAIN_LAYERS layers, f32, on the attention ``backend``."""
    from repro_torch.configs import RunConfig, ShapeConfig, get_arch
    cfg = dataclasses.replace(get_arch(ARCH), num_layers=TRAIN_LAYERS)
    return RunConfig(
        model=cfg, shape=ShapeConfig("train_4k", "train", TRAIN_SEQ,
                                     TRAIN_BATCH),
        microbatches=2, remat=True, attention_backend=backend,
        learning_rate=1e-3, warmup_steps=2, opt_state_dtype="float32",
        opt_master=True, param_dtype="float32")


def _train(dev) -> dict:
    """Phase 6: train full-width granite-3-8b cut to TRAIN_LAYERS layers
    through the kernels, then again on the plain attention path from the
    same seeded params and batches; the per-step losses and grad norms
    must agree. Returns the kernel run's launch counts."""
    import torch

    from repro_torch._tree import tree_leaves
    from repro_torch.core.profile import profile_device
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.steps import build_train_step

    _train_grads(dev)    # phase 6a
    cfg = _train_config("kernel").model
    tokens = TRAIN_BATCH * TRAIN_SEQ
    runs = {}
    for backend in ("kernel", "dense"):
        rcfg = _train_config(backend)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)    # left by earlier phases
        t0 = time.perf_counter()
        step, model, opt = build_train_step(rcfg, total_steps=TRAIN_STEPS,
                                            device=dev)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        opt_state = opt.init(params)
        torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(params))
        data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                           device=str(dev))
        per_step = []

        def counted(p, o, batch):
            before = dict(ops.LAUNCHES)
            out = step(p, o, batch)
            per_step.append({k: ops.LAUNCHES[k] - before[k]
                             for k in ops.KERNELS})
            return out

        ops.reset_launches()
        res = train_loop.run(counted, params, opt_state, data.batch_at,
                             total_steps=TRAIN_STEPS)
        launches = dict(ops.LAUNCHES)
        if backend == "kernel":    # one more step, traced, after the count
            # [1]: keep only the summary, not the step's (params, state)
            prof = profile_device(lambda: step(params, opt_state,
                                               data.batch_at(TRAIN_STEPS)))[1]
            emit({"phase": "train_profile", "backend": backend,
                  "step": TRAIN_STEPS, **prof})
        steps = [{**m, "tokens_per_s": tokens / m["step_s"],
                  "launches": per_step[i]} for i, m in enumerate(res.metrics)]
        emit({"phase": "train", "backend": backend, "arch": ARCH,
              "layers": TRAIN_LAYERS,
              "reduced": f"depth {cfg.num_layers} of 40 layers: f32 params, "
                         "grads, master and two AdamW moments of 40 layers "
                         "(~164 GB) exceed one 80 GB card",
              "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "microbatches": 2, "remat": True, "setup_s": setup_s,
              "allocated_before_bytes": held,
              "retries": res.retries, "steps": steps,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
              "launches": launches})
        runs[backend] = (res.metrics, launches, per_step, res.retries)
        del step, model, opt, params, opt_state, res, counted
        gc.collect()
        torch.cuda.empty_cache()

    (km, launches, per_step, k_retries), (dm, _, _, d_retries) = \
        runs["kernel"], runs["dense"]
    rel = {key: [abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(km, dm)]
           for key in TRAIN_TOL}
    parity = {"phase": "train_parity", "steps": len(km),
              "losses_kernel": [m["loss"] for m in km],
              "losses_dense": [m["loss"] for m in dm],
              "rel_diff": rel, "tol": TRAIN_TOL}
    emit(parity)
    need = ("flash_attention_lse", "flash_attention_dq", "flash_attention_dkv",
            "rmsnorm")
    if (len(km) != TRAIN_STEPS or len(dm) != TRAIN_STEPS or k_retries
            or d_retries):
        raise AssertionError(f"training did not take {TRAIN_STEPS} clean "
                             f"steps: {parity}")
    if any(max(rel[key]) > TRAIN_TOL[key] for key in TRAIN_TOL):
        raise AssertionError(f"kernel and plain training disagree: {parity}")
    short = [(i, k) for i, c in enumerate(per_step) for k in need if c[k] < 1]
    if short:
        raise AssertionError(f"training steps launched no {short}")
    return launches


def _train_grads(dev) -> None:
    """Phase 6a: the gradient of every parameter leaf (each layer's slice
    its own leaf, as in the training step) at the seeded initial params on
    the first microbatch of step 0, through the kernels and through the
    plain attention path. Every leaf's gradient must agree within
    GRAD_TOL, relative in L2 norm: a global loss or grad norm cannot see a
    gradient that is wrong in one leaf or only in direction."""
    import torch

    from repro_torch._tree import tree_map
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.steps import make_model

    rcfg = _train_config("kernel")
    cfg, n_mb = rcfg.model, rcfg.microbatches
    models = {b: make_model(_train_config(b), device=dev)
              for b in ("kernel", "dense")}
    params = models["kernel"].init_params(
        torch.Generator(device=dev).manual_seed(0))
    batch = {k: v[:TRAIN_BATCH // n_mb] for k, v in SyntheticLM(
        cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=str(dev)).batch_at(0)
        .items()}
    grads, losses = {}, {}
    for backend, model in models.items():
        tree = {k: tree_map(lambda a: a.detach().requires_grad_(), v)
                for k, v in params.items() if k != "layers"}
        tree["layers"] = [
            tree_map(lambda a: a[i].detach().requires_grad_(),
                     params["layers"]) for i in range(cfg.num_layers)]
        named = _named_leaves(tree)
        loss, _ = model.loss(tree, batch)
        g = torch.autograd.grad(loss, [t for _, t in named])
        grads[backend] = dict(zip((n for n, _ in named), g))
        losses[backend] = float(loss.detach())
        del tree, named, loss, g
    kg, dg = grads["kernel"], grads["dense"]
    rel = {n: float((kg[n] - dg[n]).norm() / dg[n].norm()) for n in dg}
    worst = max(rel, key=rel.get)

    def norm(g):
        return float(torch.stack([t.norm() for t in g.values()]).norm())

    line = {"phase": "train_grads", "tokens": TRAIN_SEQ * TRAIN_BATCH // n_mb,
            "leaves": len(rel), "losses": losses,
            "grad_norm": {"kernel": norm(kg), "dense": norm(dg)},
            "max_rel_diff": rel[worst], "worst_leaf": worst,
            "tol": GRAD_TOL, "rel_diff_by_leaf": rel}
    emit(line)
    del grads, kg, dg, params, models
    gc.collect()
    torch.cuda.empty_cache()
    if not rel[worst] <= GRAD_TOL:
        raise AssertionError(f"kernel and plain gradients disagree: leaf "
                             f"{worst} at {rel[worst]} > {GRAD_TOL}")


def _named_leaves(tree, prefix: str = "") -> list:
    """[(dotted name, leaf)] of nested dicts and lists, in tree order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix[:-1], tree)]
    return [kv for k, v in items for kv in _named_leaves(v, f"{prefix}{k}.")]


def _eager_ms(fn, iters: int = 5) -> float:
    """Device and host time of one eager call, CUDA events around a run of
    calls after a warm-up; for calls of milliseconds, where the host's
    share is small."""
    for _ in range(2):
        fn()
    return _events_ms(fn, iters)


def _err(out, want) -> float:
    import torch
    torch.cuda.synchronize()
    return float((out.float() - want.float()).abs().max())


def _times(kernel, plain, library) -> dict:
    """Times of one call of the kernel's wrapper, its plain version and the
    library call (``None``: there is none)."""
    k_dev, k_call = _time_ms(kernel)
    return {"kernel_ms": k_dev, "kernel_call_ms": k_call,
            "plain_ms": _time_ms(plain)[0],
            "library_ms": _time_ms(library)[0] if library else None}


def _events_ms(fn, iters: int) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _time_ms(fn) -> tuple:
    """(device ms, call ms) of one call of ``fn``, after a warm-up.

    The call time is CUDA events around a run of eager calls sized to take
    about 100 ms, so where the host's cost per call (Python, the argument
    checks, the launch) exceeds the device's, it measures the host. The
    device time replays a CUDA graph that captured the same run, which
    leaves the host out: it is what the card spends on the call's
    kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up off the capture's stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    once = _events_ms(fn, 1)
    iters = int(min(200, max(5, 100.0 / max(once, 1e-3))))
    call = _events_ms(fn, iters)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device = _events_ms(graph.replay, 3) / iters
    del graph
    return device, call


def _first_mismatch(a: dict, b: dict):
    for rid in sorted(a):
        x, y = a[rid], b.get(rid, [])
        for step in range(max(len(x), len(y))):
            if step >= len(x) or step >= len(y) or x[step] != y[step]:
                return rid, step
    return None


def _ptxas_summary(log: Path) -> list:
    """Registers, shared memory and spills per compiled kernel, from the
    ``-Xptxas -v`` report the build keeps."""
    if not log.is_file():
        return []
    out = []
    fn = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        elif fn and ("Used" in line or "spill" in line):
            out.append(f"{fn}: {line.split('info    :')[-1].strip()}")
    return out


def _triton_version() -> str:
    import triton
    return triton.__version__


if __name__ == "__main__":
    sys.exit(main())
