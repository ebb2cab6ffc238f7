"""Paper Fig. 9: compute performance vs model size, measured on the card.
The port of ``benchmarks/bench_efficiency.py``'s measured scenario: loss
forward and backward of granite-3-8b at its full width (d_model 4096, GQA
32:8, head dim 128, d_ff 12800, tied vocab 49155) cut to 1, 2, 4 and 8
layers, one row of 4096 tokens, f32, through the port's kernels (B2, B3,
B4, K3), with remat as the training step runs it. Derived: GFLOP/s of
``6 x param_count x tokens`` over the measured call.

``efficiency/projected`` reads the dry run's records
(``results/dryrun_torch/*_train_4k_16x16.json``, written by
``python -m repro_torch.launch.dryrun --all``): TFLOP/s per arch at the
roofline step time of the full-scale step on H100s.

The workload's knobs: ``num_layers``, ``batch``, ``seq``; ``device``
(``cuda`` unless the caller asks for ``cpu``, as ``--device cpu`` does);
``reduced`` (the reference's reduced widths at that depth, for tests on
the CPU)."""
from __future__ import annotations

import dataclasses

from repro_torch.bench import BenchRecord, Workload, scenario, timeit_us
from repro_torch.launch.dryrun import RESULTS_DIR as DRYRUN_DIR

TRAIN_BATCH, TRAIN_SEQ = 1, 4096
NO_DRYRUN = "run launch/dryrun.py first"


def loss_step(wl: Workload):
    """(config, a callable running one loss forward and backward of the
    workload's model through the kernels, tokens per call). The callable
    is the training step's gradient pass (``accumulate_grads``: per-layer
    leaves, one microbatch) on seeded random params and a SyntheticLM
    batch."""
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import Runtime, build
    from repro_torch.models.model import resolve_device
    from repro_torch.runtime.steps import accumulate_grads

    device = resolve_device(wl.knobs.get("device", "cuda"))
    L = wl.knobs["num_layers"]
    cfg = get_arch(wl.arch)
    cfg = (reduced(cfg, layers=L) if wl.knobs.get("reduced")
           else dataclasses.replace(cfg, num_layers=L))
    batch_rows = wl.knobs.get("batch", TRAIN_BATCH)
    seq = wl.knobs.get("seq", TRAIN_SEQ)
    model = build(cfg, Runtime(attention_backend="kernel"), device=device)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    batch = SyntheticLM(cfg, batch_rows, seq, seed=0,
                        device=str(device)).batch_at(0)

    def step():
        return accumulate_grads(model, params, batch, 1)

    return cfg, step, batch_rows * seq


def _workloads(layers=(1, 2, 4, 8)):
    return [Workload(label=f"layers{L}", arch="granite-3-8b",
                     knobs={"num_layers": L, "batch": TRAIN_BATCH,
                            "seq": TRAIN_SEQ})
            for L in layers]


@scenario(
    "efficiency/measured", tags=("measured", "fig9"),
    paper_ref="Fig. 9 (measured, full width)", workloads=_workloads())
def efficiency_measured(wl: Workload):
    """Loss forward + backward GFLOP/s vs layer count, granite-3-8b at
    full width on the card."""
    cfg, step, tokens = loss_step(wl)
    us = timeit_us(step, iters=5, warmup=2)
    flops = 6.0 * cfg.param_count() * tokens
    yield BenchRecord(
        name=f"efficiency/{wl.label}/measured", us_per_call=us,
        derived={"gflops_s": round(flops / (us * 1e-6) / 1e9, 2)})


@scenario(
    "efficiency/projected", tags=("projected", "fig9"),
    paper_ref="Fig. 9 (full-scale projection)",
    workloads=[Workload(label="train_4k_16x16",
                        knobs={"shape": "train_4k", "mesh": "16x16"})])
def efficiency_projected(wl: Workload):
    """Full-scale roofline-step-time TFLOP/s per arch from the dry run's
    records (when present)."""
    from repro_torch.core.report import load_dryrun_records

    recs = [r for r in load_dryrun_records(
        wl.knobs.get("dir", DRYRUN_DIR), wl.knobs["mesh"])
        if r["shape"] == wl.knobs["shape"]]
    for rec in recs:
        rl = rec["roofline"]
        tf = rl["model_flops"] / max(rl["step_time_s"], 1e-12) / 1e12
        yield BenchRecord(
            name=f"efficiency/{rec['arch']}/projected",
            arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
            derived={"tflops": round(tf, 1), "mfu": round(rl["mfu"], 3)})
    if not recs:
        yield BenchRecord(name="efficiency/no_dryrun_artifacts",
                          derived={"note": NO_DRYRUN})
