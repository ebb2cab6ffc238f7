"""Measured multi-rank scaling matrix (Tier-2, paper Fig. 11 / Table III):
the port of ``benchmarks/bench_scaling_matrix.py``, under the same record
names and derived keys.

Drives the real DP/TP path (``parallel/sharding`` and the collectives of
the sharded step) and GPipe (``parallel/pipeline``) on the ranks of a
process group, one start per rank count
(:func:`repro_torch.launch.mesh.run_with_ranks`), cached so the dp, tp,
mixed and trace scenarios share them. Each rank count's start captures one
train-step trace per split (:func:`repro_torch.trace.capture.
capture_matrix_cell`): its samples are the measured step times here, and
its DAG is what ``trace_replay/*`` replays. Records carry:

* ``efficiency`` -- throughput against the one-rank run of the same global
  problem (``core/scalability.scaling_efficiency``);
* ``collective_frac`` -- upper bound of the step's share in collectives
  and partitioning (``collective_time_fraction``);
* ``shard_balance`` -- Eq. 3 over per-shard work (batch rows for DP,
  attention heads for TP; a starved shard pins it to 0);
* PP rows check the paper's "throughput = most-loaded stage" model:
  ``model_ratio`` is measured over predicted step time with the per-layer
  time calibrated on the balanced split, beside Eq. 2/3 stage metrics.

Where it runs: ``--device cpu`` runs the reference's grid on gloo ranks
(granite-3-8b reduced to 2 layers, d_model 128, d_ff 256, vocab 512, B8
S64; the PP toy stack L8 D128, M8 microbatches of 2 x 32). On the card
(the default) each point runs where the machine has its cards, one card a
rank over NCCL, at granite-3-8b's published width (d_model 4096, GQA 32:8,
d_ff 12800, tied vocab 49,155) cut to 2 layers, f32, global batch 8 x seq
1024 (8,192 tokens), and the PP stack at the same width and tokens (L8
D4096, M8 microbatches of 1 x 1024), so that the stages' products, not
send, recv and launches, set its time; every other point's record names
it as not run for want of cards. The timing gates (``model_ok``, the PP
ordering) are for runs on cards and harness runs, not for unit tests.
"""
from __future__ import annotations

import functools
import statistics
from typing import Dict, List, Tuple

from repro_torch.bench import BenchRecord, TimingStats, Workload, scenario

ARCH = "granite-3-8b"
DEVICE_COUNTS = (1, 2, 4, 8)
# rank count -> (data, model) splits measured by that count's ranks
SPLITS: Dict[int, Tuple[Tuple[int, int], ...]] = {
    1: ((1, 1),),
    2: ((2, 1), (1, 2)),
    4: ((4, 1), (1, 4)),
    8: ((8, 1), (1, 8), (4, 2), (2, 4)),
}
PP_STAGE_SPLITS = ((2, 2, 2, 2), (1, 2, 2, 3), (1, 1, 1, 5))
PP_RANKS = 4
# the grid on each device: the step's model, batch, sequence, and timing
GRID = {
    "cpu": dict(reduce_kw=dict(layers=2, d_model=128, d_ff=256, vocab=512),
                num_layers=0, batch=8, seq=64, iters=5, warmup=2),
    "cuda": dict(reduce_kw={}, num_layers=2, batch=8, seq=1024, iters=3,
                 warmup=1),
}
# the PP stack on each device: layers, width, microbatches of MB x SS
PP_DIMS = {"cpu": dict(L=8, D=128, M=8, MB=2, SS=32),
           "cuda": dict(L=8, D=4096, M=8, MB=1, SS=1024)}


def _kind(device: str) -> str:
    return "cuda" if device.startswith("cuda") else "cpu"


def grid(device: str) -> dict:
    return GRID[_kind(device)]


def pp_dims(device: str) -> dict:
    return PP_DIMS[_kind(device)]


def tokens(device: str) -> int:
    g = grid(device)
    return g["batch"] * g["seq"]


def cards_missing(n: int, device: str):
    """Why an ``n``-rank point does not run here (None: it runs): on the
    card, a point needs ``n`` cards."""
    if not device.startswith("cuda"):
        return None
    import torch
    have = torch.cuda.device_count()
    return f"needs {n} cards; this machine has {have}" if n > have else None


@functools.lru_cache(maxsize=None)
def mesh_traces(n_devices: int, device: str) -> Dict[str, object]:
    """split name -> the captured train-step trace of each split of
    ``n_devices`` ranks, from one start of them."""
    from repro_torch.trace.capture import capture_matrix_cell

    g = grid(device)
    traces = capture_matrix_cell(
        n_devices, SPLITS[n_devices], arch=ARCH, batch=g["batch"],
        seq=g["seq"], reduce_kw=g["reduce_kw"], num_layers=g["num_layers"],
        iters=g["iters"], warmup=g["warmup"], device=device)
    return {tr.mesh: tr for tr in traces}


def pp_rank(rank: int, n: int, layouts, dims: dict, device: str,
            iters: int = 5, warmup: int = 2) -> Dict[str, List[float]]:
    """One stage of the GPipe stack: each layout's forward times (the
    device synchronised around each)."""
    import time

    import torch

    from repro_torch.configs import MeshConfig
    from repro_torch.core.scalability import _sync
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_forward, stack_stages

    mesh = make_mesh(MeshConfig(shape=(n,), axes=("model",)), device)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    L, D, M, MB, SS = (dims[k] for k in ("L", "D", "M", "MB", "SS"))
    params = {"w1": (torch.randn((L, D, D), generator=g) * 0.05).to(dev),
              "w2": (torch.randn((L, D, D), generator=g) * 0.05).to(dev)}
    x = torch.randn((M, MB, SS, D), generator=g).to(dev)
    s = mesh.get_local_rank("model")

    def layer_fn(c, p):
        return c + torch.tanh(c @ p["w1"]) @ p["w2"]

    out = {}
    for layout in layouts:
        staged, mask = stack_stages(params, layout)
        local = {k: v[s] for k, v in staged.items()}
        args = (local, mask[s], x, layer_fn, mesh)
        samples = []
        with torch.no_grad():
            for i in range(warmup + iters):
                _sync()
                t0 = time.perf_counter()
                pipeline_forward(*args)
                _sync()
                if i >= warmup:
                    samples.append(time.perf_counter() - t0)
        out["-".join(map(str, layout))] = samples
    return out


@functools.lru_cache(maxsize=None)
def pp_results(device: str) -> Dict[str, List[float]]:
    from repro_torch.launch.mesh import run_with_ranks

    g = grid(device)
    return run_with_ranks(pp_rank, PP_RANKS, PP_STAGE_SPLITS,
                          pp_dims(device), device, g["iters"], g["warmup"], timeout=900,
                          device=device)[0]


def _median_s(samples_s: List[float]) -> float:
    return float(statistics.median(samples_s))


def split_name(kind: str, shape: Tuple[int, int], n_devices: int) -> str:
    split = "x".join(map(str, shape))
    return (f"scaling_matrix/{kind}{n_devices}" if kind != "mix"
            else f"scaling_matrix/mix_{split}")


def work_units(shape: Tuple[int, int], batch: int, heads: int) -> list:
    """Per-shard work of a split: batch rows over DP replicas, attention
    heads over TP shards (a TP shard past the head count sits idle)."""
    from repro_torch.core.scalability import even_shard_sizes

    dp, tp = shape
    return (even_shard_sizes(batch, dp) if tp == 1
            else even_shard_sizes(heads, tp))


def _not_run(name: str, why: str, n: int, split: str) -> BenchRecord:
    return BenchRecord(name=name, mesh=split,
                       knobs={"devices": n, "split": split},
                       derived={"not_run": why, "ranks": n})


def _split_record(kind: str, shape: Tuple[int, int], n_devices: int,
                  device: str) -> BenchRecord:
    """One DP/TP/mixed record: the measured split against the one-rank
    baseline."""
    from repro_torch.core.scalability import (collective_time_fraction,
                                              scaling_efficiency,
                                              shard_balance)

    split = "x".join(map(str, shape))
    name = split_name(kind, shape, n_devices)
    why = cards_missing(n_devices, device)
    if why:
        return _not_run(name, why, n_devices, split)
    tr = mesh_traces(n_devices, device)[split]
    base = mesh_traces(1, device)["1x1"]
    t_n = _median_s(tr.samples_s)
    t_1 = _median_s(base.samples_s)
    tok = tokens(device)
    heads = int(tr.meta.get("heads", 4))
    return BenchRecord(
        name=name,
        mesh=split,
        us_per_call=TimingStats([t * 1e6 for t in tr.samples_s]),
        knobs={"devices": n_devices, "split": split, "kind": kind},
        derived={
            "tok_s": round(tok / t_n, 1),
            "efficiency": round(scaling_efficiency(tok / t_n, tok / t_1), 4),
            "collective_frac": round(collective_time_fraction(t_n, t_1), 4),
            "shard_balance": round(shard_balance(
                work_units(shape, int(tr.meta["batch"]), heads)), 4),
            "backend": "nccl" if device.startswith("cuda") else "gloo",
        },
    )


def _device(wl: Workload) -> str:
    from repro_torch.models.model import resolve_device
    return resolve_device(wl.knobs.get("device", "cuda")).type


_TAGS = ("tier2", "measured", "fig11", "table3", "scaling_matrix")


@scenario(
    "scaling_matrix/dp", tags=_TAGS,
    paper_ref="Fig. 11a / Table III (measured mesh matrix)",
    workloads=[Workload(label=f"n{n}", arch=ARCH, knobs={"devices": n})
               for n in DEVICE_COUNTS])
def scaling_matrix_dp(wl: Workload):
    """DP replica scaling on 1/2/4/8 ranks."""
    n = wl.knobs["devices"]
    yield _split_record("dp", (n, 1), n, _device(wl))


@scenario(
    "scaling_matrix/tp", tags=_TAGS,
    paper_ref="Fig. 11b / Table III (measured mesh matrix)",
    workloads=[Workload(label=f"n{n}", arch=ARCH, knobs={"devices": n})
               for n in DEVICE_COUNTS if n > 1])
def scaling_matrix_tp(wl: Workload):
    """TP width scaling on 2/4/8 ranks."""
    n = wl.knobs["devices"]
    yield _split_record("tp", (1, n), n, _device(wl))


@scenario(
    "scaling_matrix/mixed", tags=_TAGS,
    paper_ref="Table III (DP x TP interior splits)",
    workloads=[Workload(label="4x2", arch=ARCH, knobs={"devices": 8}),
               Workload(label="2x4", arch=ARCH, knobs={"devices": 8})])
def scaling_matrix_mixed(wl: Workload):
    """Interior DPxTP splits of the 8-rank mesh (4x2, 2x4)."""
    shape = tuple(int(x) for x in wl.label.split("x"))
    yield _split_record("mix", shape, wl.knobs["devices"], _device(wl))


def pp_derived(stage_layers, samples_s: List[float],
               balanced_s: List[float], dims: dict) -> dict:
    """The PP record's derived keys: Eq. 2/3 stage metrics and the
    most-loaded-stage model, its per-layer time calibrated on the
    balanced split's samples; ``dims`` the stack's (:data:`PP_DIMS`)."""
    from repro_torch.core.scalability import (pp_calibrate_per_layer,
                                              pp_model_check,
                                              pp_stage_balance)
    from repro_torch.parallel.pipeline import pipeline_allocation

    M = dims["M"]
    per_layer = pp_calibrate_per_layer(_median_s(balanced_s),
                                       PP_STAGE_SPLITS[0], M)
    t = _median_s(samples_s)
    check = pp_model_check(t, stage_layers, M, per_layer)
    tok = M * dims["MB"] * dims["SS"]
    return {
        "tok_s": round(tok / t, 1),
        "max_stage": max(stage_layers),
        "stage_balance": round(pp_stage_balance(stage_layers), 4),
        "allocation": round(pipeline_allocation(stage_layers), 4),
        "predicted_us": round(check.predicted_s * 1e6, 1),
        "model_ratio": round(check.ratio, 4),
        "model_ok": check.within(),
    }


@scenario(
    "scaling_matrix/pp", tags=("tier2", "measured", "fig11",
                               "scaling_matrix"),
    paper_ref="Fig. 11c (most-loaded-stage model, measured)",
    workloads=[Workload(label="-".join(map(str, sl)), arch=ARCH,
                        knobs={"devices": PP_RANKS, "stage_layers": sl})
               for sl in PP_STAGE_SPLITS])
def scaling_matrix_pp(wl: Workload):
    """GPipe layer-allocation splits on 4 ranks, checked against the
    most-loaded-stage bottleneck model."""
    device = _device(wl)
    stage_layers = tuple(wl.knobs["stage_layers"])
    name = f"scaling_matrix/pp_{wl.label}"
    why = cards_missing(PP_RANKS, device)
    if why:
        yield _not_run(name, why, PP_RANKS, str(PP_RANKS))
        return
    res = pp_results(device)
    balanced = "-".join(map(str, PP_STAGE_SPLITS[0]))
    yield BenchRecord(
        name=name, mesh=str(PP_RANKS),
        us_per_call=TimingStats([s * 1e6 for s in res[wl.label]]),
        derived=pp_derived(stage_layers, res[wl.label], res[balanced],
                           pp_dims(device)))
