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
6. the ``kernels`` summary line, with the launch counts of phase 3.

Any failure raises and exits non-zero. Without a CUDA device, or outside a
checkout, it exits non-zero before printing any result. The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH = "granite-3-8b"
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12
TOL = {"float32": 5e-4, "bfloat16": 2e-2}
KERNELS = {
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:40"),
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
        line["ok"] = line["max_abs_err"] <= line["tol"]
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
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{[(f['kernel'], f['shape'], f['dtype']) for f in failures]}")

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

    # ----------------------------------------------------------- 6 kernels
    total = {k: sum(launches[e][k] for e in launches) for k in KERNELS}
    need = {"flash_attention": launches["continuous"]["flash_attention"],
            "paged_attention": launches["paged"]["paged_attention"],
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
        raise AssertionError(f"the serving path never launched {missing}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
