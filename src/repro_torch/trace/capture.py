"""Trace capture: decompose a measured step into a replayable DAG, the
counterpart of ``repro/trace/capture.py``.

Two recorders:

* **Train step** -- :func:`capture_train_trace` times the real training
  step with its own timers (the device synchronised around each call),
  counts one more call of the same step with
  :func:`repro_torch.core.cost.count_cost`, then apportions the measured
  median across per-op events: each lane (compute / memory / collective)
  is a chain of the step's heaviest operations, costed at its roofline
  seconds on a :class:`~repro_torch.core.roofline.Chip` (default
  :data:`~repro_torch.core.roofline.H100`: compute at the peak of the
  step's parameter dtype, memory at its HBM rate, collectives at its
  link rate) times one measured/roofline calibration ratio. The lanes run
  in parallel between a root and a sink (the roofline's overlap
  assumption made explicit as DAG structure), so the identity replay
  reconstructs the measured step and what-if edits shift real, named
  operations.
* **Serving** -- :class:`TracingClock` wraps an engine clock (the port's
  ``WallClock`` or ``SimClock``) and records one event per prefill or
  decode charge at the engines' dispatch seam; no engine code changes.
  The trace is a measured dispatch chain whose identity replay equals
  the engine's busy time.

:func:`capture_matrix_cell` runs the train-step recorder on the ranks of
a process group of its own (:func:`repro_torch.launch.mesh.run_with_ranks`,
gloo on the CPU, NCCL on cards), one start per rank count, each returning
one trace per split.

The reference costs every step at its chip's bf16 peak; the port holds no
TPU constant, and a caller that wants another chip's rates passes its own
:class:`~repro_torch.core.roofline.Chip`.
"""
from __future__ import annotations

import statistics
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.trace.schema import Trace, TraceEvent

# the reduced model the measured scaling matrix runs on the CPU
MATRIX_REDUCE_KW = dict(layers=2, d_model=128, d_ff=256, vocab=512)


# --------------------------------------------------------- DAG decomposition
def _lane_items(
    by_op: Dict[str, float], rate: float, ops_per_lane: int
) -> List[Tuple[str, float]]:
    """Top ops of one lane as (op, roofline_seconds), heaviest first,
    the tail lumped into one "other" event so lane totals stay exact."""
    items = sorted(
        ((op, amt) for op, amt in by_op.items() if amt > 0),
        key=lambda kv: -kv[1],
    )
    head = items[: max(1, ops_per_lane - 1)]
    tail = sum(amt for _, amt in items[len(head):])
    out = [(op, amt / rate) for op, amt in head]
    if tail > 0:
        out.append(("other", tail / rate))
    return out


def dag_from_cost_summary(
    summary: Dict[str, Any],
    measured_s: float,
    *,
    ops_per_lane: int = 6,
    chip=None,
    dtype: str = "float32",
) -> Tuple[List[TraceEvent], Dict[str, float]]:
    """Build the lane DAG from a cost summary (:func:`cost_summary`) and a
    measured step.

    ``summary`` carries per-device totals and per-op breakdowns
    (``flops_by_op``, ``bytes_by_op``, ``collective_ici_by_op``), costed
    on ``chip`` (default :data:`~repro_torch.core.roofline.H100`; compute
    at its ``dtype`` peak). Returns ``(events, extras)`` where ``extras``
    holds the calibration ratio (measured over the roofline max-lane time)
    and the raw per-lane roofline seconds.
    """
    from repro_torch.core.roofline import H100

    chip = chip or H100
    lanes = {
        "compute": _lane_items(
            summary.get("flops_by_op", {}), chip.peak(dtype), ops_per_lane
        ),
        "memory": _lane_items(
            summary.get("bytes_by_op", {}), chip.hbm_bw, ops_per_lane
        ),
        "collective": _lane_items(
            summary.get("collective_ici_by_op", {}), chip.link_bw,
            ops_per_lane,
        ),
    }
    roofline_s = {
        kind: sum(s for _, s in items) for kind, items in lanes.items()
    }
    max_lane = max(roofline_s.values(), default=0.0)
    events: List[TraceEvent] = [
        TraceEvent("root", "host", "dispatch", 0.0)
    ]
    if max_lane <= 0:
        # nothing to decompose (no summary): one opaque step event
        events.append(
            TraceEvent("step", "host", "step", measured_s, deps=("root",))
        )
        events.append(TraceEvent("sink", "host", "sync", 0.0, deps=("step",)))
        return events, {"calibration_ratio": 1.0, **{
            f"roofline_{k}_s": v for k, v in roofline_s.items()}}
    ratio = measured_s / max_lane
    tails: List[str] = []
    for kind, items in lanes.items():
        prev = "root"
        for i, (op, roof_s) in enumerate(items):
            eid = f"{kind}{i}:{op}"
            events.append(
                TraceEvent(
                    eid,
                    kind,
                    op,
                    roof_s * ratio,
                    deps=(prev,),
                    meta={"roofline_s": roof_s},
                )
            )
            prev = eid
        if prev != "root":
            tails.append(prev)
    events.append(TraceEvent("sink", "host", "sync", 0.0, deps=tuple(tails)))
    extras = {"calibration_ratio": ratio}
    for kind, v in roofline_s.items():
        extras[f"roofline_{kind}_s"] = v
    return events, extras


def cost_summary(report) -> Dict[str, Any]:
    """Wire format of a :class:`~repro_torch.core.cost.CostReport` for
    trace metadata and the ranks' transport: totals plus the per-op
    breakdowns the DAG is made of."""
    return {
        "flops": report.flops,
        "dot_flops": report.dot_flops,
        "bytes": report.bytes,
        "ici_bytes": report.collective_ici_bytes,
        "collective_bytes": report.collective_bytes,
        "flops_by_op": dict(report.flops_by_op),
        "bytes_by_op": dict(report.bytes_by_op),
        "collective_ici_by_op": report.collective_ici_summary(),
    }


def trace_from_cell_payload(
    payload: Dict[str, Any],
    *,
    name: str,
    arch: str = "",
    shape: str = "",
    mesh: str = "",
    n_devices: int = 1,
    kind: str = "train_step",
    ops_per_lane: int = 6,
    chip=None,
) -> Trace:
    """Assemble a :class:`Trace` from one captured cell: measured
    ``samples_s``, a cost ``summary`` and cell ``meta`` (whose ``dtype``,
    f32 if absent, picks the compute peak)."""
    samples = [float(s) for s in payload["samples_s"]]
    measured = float(statistics.median(samples))
    meta = dict(payload.get("meta", {}))
    events, extras = dag_from_cost_summary(
        payload.get("summary", {}), measured, ops_per_lane=ops_per_lane,
        chip=chip, dtype=meta.get("dtype", "float32"),
    )
    summary = payload.get("summary", {})
    for key in ("flops", "dot_flops", "bytes", "ici_bytes",
                "collective_bytes"):
        if key in summary:
            meta[key] = summary[key]
    meta.update(extras)
    trace = Trace(
        name=name,
        kind=kind,
        arch=arch,
        shape=shape,
        mesh=mesh,
        n_devices=n_devices,
        measured_step_s=measured,
        samples_s=samples,
        events=events,
        meta=meta,
    )
    trace.validate()
    return trace


# ------------------------------------------------------- train-step capture
def capture_train_trace(
    arch: str = "granite-3-8b",
    *,
    split: Tuple[int, int] = (1, 1),
    batch: int = 8,
    seq: int = 64,
    reduce_kw: Optional[Dict[str, int]] = None,
    num_layers: int = 0,
    iters: int = 5,
    warmup: int = 2,
    ops_per_lane: int = 6,
    device: str = "cuda",
    chip=None,
) -> Trace:
    """Capture one train-step trace on this process's ranks.

    The scaling matrix's cell (:mod:`repro_torch.bench.suites.
    scaling_matrix`): ``arch`` reduced by ``reduce_kw`` (default
    :data:`MATRIX_REDUCE_KW`; ``{}`` for the published width), cut to
    ``num_layers`` where given, f32, the resident sharded step over a
    (data, model) mesh of ``split`` through the attention kernels. A
    split wider than one rank needs a process group of ``dp * tp`` ranks
    (:func:`capture_matrix_cell` starts one); a 1x1 split without one
    runs the one-device step. The step is timed ``iters`` times after
    ``warmup`` calls, then counted once more (the same step)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import (ARCHS, MeshConfig, RunConfig,
                                     ShapeConfig)
    from repro_torch.configs import reduced as reduce_cfg
    from repro_torch.core.cost import count_cost
    from repro_torch.core.profiler import model_flops_for
    from repro_torch.core.scalability import _sync
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import resolve_device
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime.steps import build_train_step

    reduce_kw = dict(MATRIX_REDUCE_KW if reduce_kw is None else reduce_kw)
    cfg = reduce_cfg(ARCHS[arch], **reduce_kw) if reduce_kw else ARCHS[arch]
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    dp, tp = split
    n_devices = dp * tp
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices and not (n_devices == 1 and not
                                   dist.is_initialized()):
        raise RuntimeError(
            f"split {dp}x{tp} needs {n_devices} ranks, this process group "
            f"has {world} (capture_matrix_cell starts one of its size)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dist.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh_cfg = MeshConfig(shape=tuple(split), axes=("data", "model"))
    shape = ShapeConfig("trace", "train", seq, batch)
    rcfg = RunConfig(model=cfg, shape=shape, mesh=mesh_cfg,
                     param_dtype="float32", attention_backend="kernel",
                     exec_mode="resident")
    mesh = make_mesh(mesh_cfg, dev.type) if dist.is_initialized() else None
    step, model, opt = build_train_step(rcfg, device=dev, mesh=mesh)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    if mesh is not None:
        params = shd.shard_tree(params, model.rt.param_specs, mesh)
    opt_state = opt.init(params)
    data = SyntheticLM(cfg, batch, seq, seed=0, device=str(dev)).batch_at(0)
    for _ in range(warmup):
        step(params, opt_state, data)
    samples = []
    for _ in range(iters):
        _sync()
        # train capture measures the real step; the Sim-clock discipline
        # only binds the serving path (TracingClock)
        t0 = time.perf_counter()  # repro: allow=RS104
        step(params, opt_state, data)
        _sync()
        samples.append(time.perf_counter() - t0)  # repro: allow=RS104
    _, report = count_cost(step, params, opt_state, data)
    payload = {
        "samples_s": samples,
        "summary": cost_summary(report),
        "meta": {
            "model_flops": model_flops_for(cfg, shape),
            "param_count": float(cfg.param_count()),
            "d_model": cfg.d_model,
            "layers": cfg.num_layers + cfg.encoder_layers,
            "heads": cfg.num_heads,
            "tokens": batch * seq,
            "batch": batch,
            "seq": seq,
            "split": [dp, tp],
            "reduce_kw": reduce_kw,
            "num_layers": cfg.num_layers,
            "dtype": "float32",
            "device": dev.type,
            "kernels": report.kernels,
        },
    }
    return trace_from_cell_payload(
        payload,
        name=f"train/{arch}/{dp}x{tp}",
        arch=arch,
        shape=shape.name,
        mesh=f"{dp}x{tp}",
        n_devices=n_devices,
        ops_per_lane=ops_per_lane,
        chip=chip,
    )


def _capture_rank(rank: int, n: int, splits, kw: dict) -> List[str]:
    """One rank of :func:`capture_matrix_cell`: every split's trace as
    JSON, each split on a mesh of its own."""
    return [capture_train_trace(split=tuple(split), **kw).to_json()
            for split in splits]


def capture_matrix_cell(
    n_devices: int,
    splits: Sequence[Tuple[int, int]],
    *,
    arch: str = "granite-3-8b",
    batch: int = 8,
    seq: int = 64,
    reduce_kw: Optional[Dict[str, int]] = None,
    num_layers: int = 0,
    iters: int = 5,
    warmup: int = 2,
    timeout: int = 900,
    device: str = "cpu",
) -> List[Trace]:
    """Capture train-step traces for ``splits`` on ``n_devices`` ranks
    started for them (gloo on ``cpu``, NCCL on ``cuda``, one card a rank):
    rank 0's trace of each split, whose counts are rank 0's."""
    from repro_torch.launch.mesh import run_with_ranks

    kw = dict(arch=arch, batch=batch, seq=seq,
              reduce_kw=dict(MATRIX_REDUCE_KW if reduce_kw is None
                             else reduce_kw),
              num_layers=num_layers, iters=iters, warmup=warmup,
              device=device)
    lines = run_with_ranks(_capture_rank, n_devices,
                           [list(s) for s in splits], kw, timeout=timeout,
                           device=device)[0]
    out: List[Trace] = []
    for line in lines:
        trace = Trace.from_json(line)
        trace.validate()
        out.append(trace)
    return out


# ----------------------------------------------------------- serving capture
class TracingClock:
    """Record the serving engines' prefill/decode dispatches as trace
    events, from the clock seam every engine already charges.

    Wraps an engine clock (``WallClock``, ``SimClock``): ``charge`` is
    called once per prefill-chunk dispatch and per pool decode step
    (``serving/engine.py``, ``serving/paged.py``), so the elapsed
    inner-clock time since the previous charge or wait IS that dispatch's
    cost: real dispatch and host time under a wall clock, the charged cost
    under a sim clock. Idle waits (``wait_until``) advance the mark
    without emitting events, so the trace records busy time only.
    """

    def __init__(self, inner=None) -> None:
        if inner is None:
            from repro_torch.serving.request import WallClock

            inner = WallClock()
        self.inner = inner
        self.events: List[TraceEvent] = []
        self._mark = inner.now()
        self._prev: Optional[str] = None

    def now(self) -> float:
        return self.inner.now()

    def charge(self, kind: str, n: int = 1,
               role: Optional[str] = None) -> None:
        self.inner.charge(kind, n)
        t1 = self.inner.now()
        cost = max(t1 - self._mark, 0.0)
        eid = f"{kind}{len(self.events)}"
        self.events.append(
            TraceEvent(
                eid,
                kind,
                kind,
                cost,
                deps=(self._prev,) if self._prev else (),
                meta={"n": n, "role": role or kind},
            )
        )
        self._mark = t1
        self._prev = eid

    def wait_until(self, t: float) -> None:
        self.inner.wait_until(t)
        self._mark = self.inner.now()

    def trace(self, name: str = "serve", **provenance) -> Trace:
        """The recorded dispatch chain as a replayable trace; the
        measured step is the engine's total busy (charged) time."""
        busy = sum(ev.cost_s for ev in self.events)
        lanes: Dict[str, int] = {}
        for ev in self.events:
            lanes[ev.kind] = lanes.get(ev.kind, 0) + 1
        trace = Trace(
            name=name,
            kind="serve",
            measured_step_s=busy,
            samples_s=[busy],
            events=list(self.events),
            meta={"busy_s": busy, "dispatches": dict(lanes)},
            **provenance,
        )
        trace.validate()
        return trace
