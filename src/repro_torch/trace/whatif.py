"""What-if edits and cross-split prediction over captured traces, the
counterpart of ``repro/trace/whatif.py``.

Three edit factories (:func:`scale_op`, :func:`scale_kind`,
:func:`set_cost`) answer local questions — "step time if matmuls were
2x faster" — by rescaling event costs inside the captured DAG and
replaying it.

:func:`predict_split` answers the global question — "step time under a
different (data, model) split" — by re-costing the trace's three lanes
with first-principles scaling rules at the trace's own calibrated rates
and replaying the re-costed lane DAG (the prediction is a replay, not a
formula: the same earliest-start walk the identity gate validates).
Scaling rules:

* compute: per-device FLOPs scale with 1/devices;
* memory: the weight-read share (``min(1, 3 x param_bytes / traffic)``)
  scales with the model split, the activation share with the data
  split;
* collectives: re-derived analytically (Megatron activation psums for
  TP, gradient all-reduce for DP, ring formulas) at the trace's
  calibrated ICI rate.

Cross-split error against the measured matrix is *reported*
(``trace_replay/whatif``), not gated: gloo ranks on one host share its
cores, so measured cells include host contention no per-device cost
model represents. The gate is the per-cell identity replay.

:func:`advise_from_trace` is the trace-driven ``mesh_advisor`` mode:
it rebuilds the traced model config and feeds the port's
``core.mesh_advisor.advise()`` the trace's measured calibration instead
of the chip's peaks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.trace.replay import Edit, ReplayResult, replay
from repro_torch.trace.schema import Trace, TraceError, TraceEvent


# --------------------------------------------------------------- edits
def scale_op(op: str, factor: float) -> Edit:
    """Scale every event whose ``op`` matches by ``factor``."""

    def edit(ev: TraceEvent, cost_s: float) -> float:
        return cost_s * factor if ev.op == op else cost_s

    return edit


def scale_kind(kind: str, factor: float) -> Edit:
    """Scale every event on one lane (``kind``) by ``factor``."""

    def edit(ev: TraceEvent, cost_s: float) -> float:
        return cost_s * factor if ev.kind == kind else cost_s

    return edit


def set_cost(eid: str, cost_s: float) -> Edit:
    """Pin one event's cost to an absolute value."""

    def edit(ev: TraceEvent, old: float) -> float:
        return cost_s if ev.eid == eid else old

    return edit


# ------------------------------------------------------ split prediction
def predict_split(
    trace: Trace, split: Tuple[int, int], *, chip=None
) -> ReplayResult:
    """Predict step time under a different (data, model) split by
    re-costing the trace's lanes and replaying them.

    Requires a train-step trace captured by
    :func:`repro_torch.trace.capture.capture_train_trace` (needs
    ``split``, ``param_count``, ``d_model``, ``layers``, ``tokens`` in
    ``meta``). A lane the trace never exercised takes ``chip``'s rate
    (:meth:`~repro_torch.trace.schema.Trace.calibration`).
    """
    meta = trace.meta
    for key in ("split", "param_count", "d_model", "layers", "tokens"):
        if key not in meta:
            raise TraceError(
                f"{trace.name}: meta lacks {key!r}; predict_split needs a "
                "capture_train_trace trace"
            )
    ref_dp, ref_tp = (int(x) for x in meta["split"])
    dp, tp = int(split[0]), int(split[1])
    if dp < 1 or tp < 1:
        raise TraceError(f"bad split {split!r}")
    ref_n, n = ref_dp * ref_tp, dp * tp
    lanes = trace.lane_seconds()
    cal = trace.calibration(chip)

    # compute: per-device FLOPs shrink with the device count
    compute_s = lanes.get("compute", 0.0) * ref_n / n

    # memory: split measured traffic into weight reads (scale with the
    # model split) and activation traffic (scales with the data split)
    param_bytes = float(meta["param_count"]) * 4.0  # float32 params
    traffic = float(meta.get("bytes", 0.0))
    w_share = min(1.0, 3.0 * param_bytes / traffic) if traffic > 0 else 0.5
    mem_ref = lanes.get("memory", 0.0)
    memory_s = (
        mem_ref * w_share * ref_tp / tp
        + mem_ref * (1.0 - w_share) * ref_dp / dp
    )

    # collectives: re-derived from first principles at the calibrated
    # ICI rate (the reference lane may be empty — 1x1 has no
    # collectives — so scaling it would predict zero forever)
    L = float(meta["layers"])
    d = float(meta["d_model"])
    tokens = float(meta["tokens"])
    ici_rate = float(cal.get("ici_bytes_per_s", 1.0)) or 1.0
    coll_bytes = 0.0
    if tp > 1:  # Megatron psums: 4 sites/layer, fwd+bwd, ring all-reduce
        coll_bytes += (
            4.0 * L * (tokens / dp) * d * 2.0 * 2.0 * (tp - 1) / tp
        )
    if dp > 1:  # fp32 gradient all-reduce over the data axis
        coll_bytes += param_bytes * 2.0 * (dp - 1) / dp
    collective_s = coll_bytes / ici_rate

    events = [TraceEvent("root", "host", "dispatch", 0.0)]
    for kind, cost in (
        ("compute", compute_s),
        ("memory", memory_s),
        ("collective", collective_s),
    ):
        events.append(
            TraceEvent(kind, kind, f"{kind}@{dp}x{tp}", cost, deps=("root",))
        )
    events.append(
        TraceEvent(
            "sink", "host", "sync", 0.0,
            deps=("compute", "memory", "collective"),
        )
    )
    mini = Trace(
        name=f"{trace.name}->whatif/{dp}x{tp}",
        kind=trace.kind,
        arch=trace.arch,
        shape=trace.shape,
        mesh=f"{dp}x{tp}",
        n_devices=n,
        events=events,
        meta={"ref_split": [ref_dp, ref_tp], "split": [dp, tp]},
        env=dict(trace.env),
    )
    return replay(mini)


# ------------------------------------------------------- advisor bridge
def advise_from_trace(
    trace: Trace,
    n_devices: Optional[int] = None,
    *,
    candidates: Optional[Sequence[int]] = None,
    chip=None,
) -> List:
    """Rank splits with ``core.mesh_advisor.advise`` running on the
    trace's measured rates instead of ``chip``'s peaks (default the
    H100).

    Rebuilds the traced model config from the trace's provenance
    (``arch`` + ``meta["reduce_kw"]``), then passes
    ``Trace.calibration()`` through the advisor's ``calibration=``
    seam. Returns the advisor's ``MeshAdvice`` ranking.
    """
    import dataclasses

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.configs import reduced as reduce_cfg
    from repro_torch.core.mesh_advisor import advise
    from repro_torch.core.roofline import H100

    if not trace.arch or trace.arch not in ARCHS:
        raise TraceError(
            f"{trace.name}: unknown arch {trace.arch!r}; advise_from_trace "
            "needs a trace captured against a registered arch"
        )
    cfg = ARCHS[trace.arch]
    reduce_kw = trace.meta.get("reduce_kw")
    if reduce_kw:
        cfg = reduce_cfg(cfg, **{k: int(v) for k, v in reduce_kw.items()})
    if trace.meta.get("num_layers"):       # a published width, cut
        cfg = dataclasses.replace(cfg,
                                  num_layers=int(trace.meta["num_layers"]))
    batch = int(trace.meta.get("batch", 8))
    seq = int(trace.meta.get("seq", 64))
    kind = "train" if trace.kind == "train_step" else "decode"
    shape = ShapeConfig("trace", kind, seq, batch)
    return advise(
        cfg,
        shape,
        n_devices if n_devices is not None else trace.n_devices,
        candidates=list(candidates) if candidates is not None else None,
        calibration=trace.calibration(chip),
        chip=chip or H100,
    )
