"""Paper Fig. 10: the roofline of a real training step on the card. The
port of ``benchmarks/bench_roofline.py``, from a counted step in place of
the dry-run's compiled HLO: :func:`~repro_torch.core.cost.count_cost` of
the 8-layer granite-3-8b loss forward and backward of
``efficiency/measured``, then :func:`~repro_torch.core.roofline.roofline`
against the f32 peak and Eq. 5, under the JAX keys (``dom``,
``compute_s``, ``memory_s``, ``collective_s``, ``AI``, ``mfu``) plus the
measured ``step_s``, ``mfu_measured`` and the useful share of the counted
FLOPs. The step's hand-written kernels are held to their launches: each
of B2, B3, B4 and K3 counted as many times as it launched (on the card),
each call at its per-call work.

``roofline/dryrun`` is the reference's Fig. 10 over every dry-run cell
(``results/dryrun_torch/*_16x16.json``): the three roofline terms on H100s
and Eq. 5's arithmetic intensity, each cell classed compute-, memory- or
collective-bound."""
from __future__ import annotations

from repro_torch.bench import BenchRecord, Workload, scenario, timeit_us
from repro_torch.bench.suites.efficiency import (DRYRUN_DIR, NO_DRYRUN,
                                                 TRAIN_BATCH, TRAIN_SEQ,
                                                 loss_step)

# the step's kernels, as kernels/ops.py names them
STEP_KERNELS = ("flash_attention_lse", "flash_attention_dq",
                "flash_attention_dkv", "rmsnorm")


def per_call_work(cfg, batch_rows: int, seq: int) -> dict:
    """kernel -> its work per call in a loss step of ``cfg`` at
    (batch_rows, seq) in f32: every call of a kernel in the step has the
    same shapes."""
    import torch

    from repro_torch.kernels import work

    def meta(*shape):
        return torch.empty(shape, device="meta")

    q = meta(batch_rows, seq, cfg.num_heads, cfg.resolved_head_dim)
    k = meta(batch_rows, seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    kw = dict(causal=True, window=(cfg.window if cfg.attention_kind
                                   == "sliding" else 0))
    return {"flash_attention_lse": work.flash_forward(q, k, lse=True, **kw),
            "flash_attention_dq": work.flash_dq(q, k, **kw),
            "flash_attention_dkv": work.flash_dkv(q, k, **kw),
            "rmsnorm": work.rmsnorm(batch_rows * seq, cfg.d_model, 4)}


def kernel_work_problems(kernels: dict) -> list:
    """What disagrees in ``kernels`` (kernel -> {"calls", "launches",
    "flops", "bytes", "per_call_flops", "per_call_bytes"}): a kernel of
    the step never counted; counted calls other than its launches (where
    ``launches`` is not None: on the card); counted work other than its
    calls times the per-call work."""
    out = []
    for name, k in kernels.items():
        if k["calls"] < 1:
            out.append(f"{name}: never counted")
        if k["launches"] is not None and k["calls"] != k["launches"]:
            out.append(f"{name}: counted {k['calls']} calls, launched "
                       f"{k['launches']}")
        for key in ("flops", "bytes"):
            if k[key] != k["calls"] * k[f"per_call_{key}"]:
                out.append(f"{name}: counted {key} {k[key]} != "
                           f"{k['calls']} x {k[f'per_call_{key}']}")
    return out


@scenario(
    "roofline/measured", tags=("measured", "fig10"),
    paper_ref="Fig. 10 (measured step)",
    workloads=[Workload(label="granite-3-8b/layers8", arch="granite-3-8b",
                        knobs={"num_layers": 8, "batch": TRAIN_BATCH,
                               "seq": TRAIN_SEQ})])
def roofline_measured(wl: Workload):
    """Roofline terms, MFU and Eq. 5 of a counted and timed loss step."""
    from repro_torch.core import metrics
    from repro_torch.core.cost import count_cost
    from repro_torch.core.roofline import model_flops_train, roofline
    from repro_torch.kernels import ops

    cfg, step, tokens = loss_step(wl)
    before = dict(ops.LAUNCHES)
    _, cost = count_cost(step)
    launched = {k: ops.LAUNCHES[k] - before[k] for k in ops.KERNELS}
    on_card = wl.knobs.get("device", "cuda") != "cpu"
    per_call = per_call_work(cfg, wl.knobs["batch"], wl.knobs["seq"])
    kernels = {}
    for name in STEP_KERNELS:
        got = cost.kernels.get(name, {"calls": 0, "flops": 0.0,
                                      "bytes": 0.0})
        kernels[name] = {**got,
                         "launches": launched[name] if on_card else None,
                         "per_call_flops": per_call[name].flops,
                         "per_call_bytes": per_call[name].bytes}
    problems = kernel_work_problems(kernels)
    if problems:
        raise AssertionError(f"counted kernel work disagrees: {problems}")
    us = timeit_us(step, iters=3, warmup=0)     # the counted call warmed up
    model_flops = model_flops_train(cfg.param_count(), tokens)
    rl = roofline(cost, chips=1, model_flops=model_flops, dtype="float32")
    act = metrics.activation_bytes_estimate(
        cfg.num_layers, wl.knobs["batch"], wl.knobs["seq"], cfg.d_model)
    ai = metrics.arithmetic_intensity(
        cfg.param_count(), wl.knobs["batch"], wl.knobs["seq"], act)
    step_s = us * 1e-6
    yield BenchRecord(
        name=f"roofline/{wl.label}/measured", us_per_call=us,
        arch=cfg.name,
        derived={"dom": rl.dominant, "compute_s": rl.compute_s,
                 "memory_s": rl.memory_s, "collective_s": rl.collective_s,
                 "AI": round(ai, 1), "mfu": round(rl.mfu or 0.0, 3),
                 "step_s": step_s,
                 # a CPU run's time is no measure of the card
                 "mfu_measured": (model_flops / (rl.peak_flops * step_s)
                                  if on_card else None),
                 "useful_flops_ratio": rl.useful_flops_ratio,
                 "dot_flops": cost.dot_flops, "flops": cost.flops,
                 "bytes": cost.bytes,
                 "kernels": {n: {"calls": k["calls"],
                                 "launches": k["launches"]}
                             for n, k in kernels.items()}})


@scenario(
    "roofline/dryrun", tags=("projected", "fig10"),
    paper_ref="Fig. 10",
    workloads=[Workload(label="16x16", knobs={"mesh": "16x16"})])
def roofline_dryrun(wl: Workload):
    """Roofline terms and AI for every dry-run cell on the mesh."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.core import metrics
    from repro_torch.core.report import load_dryrun_records

    emitted = False
    for rec in load_dryrun_records(wl.knobs.get("dir", DRYRUN_DIR),
                                   wl.knobs["mesh"]):
        rl = rec.get("roofline")
        if not rl:
            continue
        arch = ARCHS.get(rec["arch"])
        shape = SHAPES.get(rec["shape"])
        ai = 0.0
        if arch and shape:
            act = metrics.activation_bytes_estimate(
                arch.num_layers + arch.encoder_layers, shape.global_batch,
                shape.seq_len, arch.d_model)
            ai = metrics.arithmetic_intensity(
                arch.active_param_count(), shape.global_batch,
                shape.seq_len, act)
        emitted = True
        yield BenchRecord(
            name=f"roofline/{rec['arch']}/{rec['shape']}",
            arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
            derived={"dom": rl["dominant"],
                     "compute_s": rl["compute_s"],
                     "memory_s": rl["memory_s"],
                     "collective_s": rl["collective_s"],
                     "AI": round(ai, 1),
                     "mfu": round(rl.get("mfu") or 0.0, 3),
                     "peak_gb": rec["memory"]["peak_gb"]})
    if not emitted:
        yield BenchRecord(name="roofline/no_dryrun_artifacts",
                          derived={"note": NO_DRYRUN})
