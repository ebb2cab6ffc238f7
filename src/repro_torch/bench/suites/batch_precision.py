"""Paper Fig. 12 + Table IV: throughput against batch size and parameter
precision, the port of ``benchmarks/bench_batch_precision.py``'s measured
scenarios. What is timed is the loss gradient (no optimizer step) through
the training step's gradient pass (``accumulate_grads``, one
microbatch, the hand kernels B2, B3, B4 and K3) at S128:

* ``deploy/batch``: batch 1, 2, 4, 8, 16 and 32 in f32;
* ``deploy/precision``: f32 and bf16 params at batch 8 (bf16: bf16
  activations, the norm scales in f32, the gradients summed in f32).

On the card the model is qwen2.5-32b at its published width cut to
``CARD_LAYERS`` layers (d_model 5120, GQA 40:8, qkv bias, d_ff 27648,
untied vocab 152,064: about 3.51 B parameters); under the ``reduced``
knob (tests on the CPU) the reference's reduced block (4 layers,
d_model 256, d_ff 1024, vocab 2048). Params come from a seeded
``torch.Generator``, batches from ``synth_batch``. Derived: ``tok_s``,
tokens over the mean call.

The knobs: the reference's (``batch``, ``dtype``), ``device`` (``cuda``
unless the caller asks for ``cpu``) and ``reduced``.
``deploy/precision_fullscale`` reads the dry run's record of granite-3-8b's
bf16 ``train_4k`` cell (``results/dryrun_torch/``): the full-scale step's
memory term on H100s.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.bench import BenchRecord, Workload, scenario, timeit_us

ARCH = "qwen2.5-32b"
SEQ = 128
CARD_LAYERS = 4
REDUCED = dict(layers=4, d_model=256, d_ff=1024, vocab=2048)


def config(use_reduced: bool):
    """The suite's qwen2.5 config: the reference's reduced block, or the
    published width cut to CARD_LAYERS layers."""
    from repro_torch.configs import get_arch, reduced
    cfg = get_arch(ARCH)
    if use_reduced:
        return reduced(cfg, **REDUCED)
    return dataclasses.replace(cfg, num_layers=CARD_LAYERS)


def build_model(dtype_name: str, device, use_reduced: bool):
    """(cfg, model) of the suite in ``dtype_name`` params on the kernels,
    without remat, as the reference's block runs."""
    import torch

    from repro_torch.models import Runtime, build
    cfg = config(use_reduced)
    return cfg, build(cfg, Runtime(attention_backend="kernel", remat=False),
                      param_dtype=getattr(torch, dtype_name), device=device)


def grads(model, params, batch):
    """The timed call: the loss gradient of one microbatch (a tree like
    ``params``, f32)."""
    from repro_torch.runtime.steps import accumulate_grads
    return accumulate_grads(model, params, batch, 1)[0]


@functools.lru_cache(maxsize=4)
def _grad_fn(dtype_name: str, device: str, use_reduced: bool):
    """(cfg, model, seeded params), cached across workloads;
    ``_grad_fn.cache_clear()`` frees them."""
    import torch

    from repro_torch.models.model import resolve_device
    dev = resolve_device(device)
    cfg, model = build_model(dtype_name, dev, use_reduced)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    return cfg, model, params


def _measure(wl: Workload, dtype_name: str, batch_rows: int):
    from repro_torch.models.frontends import synth_batch
    device = wl.knobs.get("device", "cuda")
    cfg, model, params = _grad_fn(dtype_name, device,
                                  bool(wl.knobs.get("reduced")))
    batch = synth_batch(cfg, batch_rows, SEQ, kind="train", device=device)
    us = timeit_us(grads, model, params, batch, iters=3)
    return us, {"tok_s": round(batch_rows * SEQ / (us * 1e-6))}


@scenario(
    "deploy/batch", tags=("measured", "fig12"),
    paper_ref="Fig. 12",
    workloads=[Workload(label=f"batch{B}", arch=ARCH, knobs={"batch": B})
               for B in (1, 2, 4, 8, 16, 32)])
def deploy_batch(wl: Workload):
    """Throughput vs batch size (qwen2.5 block, f32 loss gradient)."""
    B = wl.knobs["batch"]
    us, derived = _measure(wl, "float32", B)
    yield BenchRecord(name=f"deploy/batch{B}", us_per_call=us,
                      derived=derived)


@scenario(
    "deploy/precision", tags=("measured", "table4"),
    paper_ref="Table IV",
    workloads=[Workload(label=dt, arch=ARCH, knobs={"dtype": dt})
               for dt in ("float32", "bfloat16")])
def deploy_precision(wl: Workload):
    """Throughput per param dtype at fixed batch (Table IV knob)."""
    dt = wl.knobs["dtype"]
    us, derived = _measure(wl, dt, 8)
    yield BenchRecord(name=f"deploy/precision_{dt}", us_per_call=us,
                      derived=derived)


@scenario(
    "deploy/precision_fullscale", tags=("projected", "table4"),
    paper_ref="Table IV (full-scale projection)",
    workloads=[Workload(label="bf16", arch="granite-3-8b")])
def deploy_precision_fullscale(wl: Workload):
    """Full-scale precision effect from the dry run's roofline memory
    term."""
    import json
    from pathlib import Path

    from repro_torch.bench.suites.efficiency import DRYRUN_DIR, NO_DRYRUN

    f = Path(wl.knobs.get("dir", DRYRUN_DIR)) / \
        "granite-3-8b_train_4k_16x16.json"
    if not f.exists():
        yield BenchRecord(name="deploy/no_dryrun_artifacts",
                          derived={"note": NO_DRYRUN})
        return
    rl = json.loads(f.read_text())["roofline"]
    yield BenchRecord(
        name="deploy/precision_fullscale_bf16",
        derived={"memory_s": round(rl["memory_s"], 2),
                 "note": "f32_would_be~2x_memory_term"})
