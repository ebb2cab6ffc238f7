"""Tier-2 trace-replay scenarios: capture -> DAG replay -> prediction, the
port of ``benchmarks/bench_trace.py`` under the same record names.

Every scenario first captures a trace of a real run, then replays its
event DAG and compares the replayed prediction with the measurement it
was decomposed from.

* ``trace_replay/matrix`` -- one trace per cell of the measured DP/TP
  scaling-matrix grid: the same splits, model and ranks as
  ``scaling_matrix/*`` (one start per rank count, shared with it). Each
  record carries ``predicted_us`` (identity replay) beside
  ``measured_us`` and their ``rel_err``, held to ``GATE_REL_ERR`` (25%)
  per cell. Traces land in ``results/traces_torch/``.
* ``trace_replay/whatif`` -- cross-split predictions from the 1x1 trace
  alone (``trace.whatif.predict_split``) against every measured cell:
  reported, not gated (ranks on one host share its cores, which no
  per-device model represents).
* ``trace_replay/advise`` -- the trace-driven ``mesh_advisor``: split
  rankings at 8 devices from the card's peaks and from the 1x1 trace's
  measured rates.
* ``trace_replay/serve`` -- a paged-engine burst under
  ``TracingClock``: the dispatch chain's identity replay equals the
  engine's busy time. On the CPU the reference's reduced engine under
  ``SimClock`` (prefill 0.5 s, decode 0.1 s); on the card granite-3-8b at
  full width and depth (the serving suite's parameters) under the wall
  clock, with 8-token prompts.
* ``trace_replay/serve_roles`` -- a chunked-prefill-heavy staggered
  stream through the interleaved paged loop and the P/D-disaggregated
  engine, each under ``TracingClock(SimClock)``: the trace's per-role
  lanes beside the decode-step stall distribution. Reported, not gated.

On the card (the default) a matrix cell runs where the machine has its
cards; every other cell's record names it as not run for want of cards,
and ``whatif`` predicts it without a measurement to compare with.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

from repro_torch.bench import BenchRecord, TimingStats, Workload, scenario
from repro_torch.bench.suites.scaling_matrix import (ARCH, DEVICE_COUNTS,
                                                     SPLITS, _device,
                                                     cards_missing,
                                                     mesh_traces, tokens)

TRACE_DIR = Path(__file__).resolve().parents[4] / "results" / "traces_torch"
GATE_REL_ERR = 0.25  # identity replay against the measured median, per cell
SERVE_REDUCE = dict(layers=2, d_model=64, vocab=128, d_ff=128)


def cell_traces(n_devices: int, device: str) -> dict:
    """split name -> the scaling matrix's captured trace, each saved."""
    out = mesh_traces(n_devices, device)
    for split, tr in out.items():
        tr.save(TRACE_DIR / f"{ARCH}-{device}-{split}.json")
    return out


def _cell_record(kind: str, shape: Tuple[int, int], n_devices: int,
                 device: str) -> BenchRecord:
    """One matrix cell: identity replay against the measurement it came
    from."""
    from repro_torch.trace import replay

    split = "x".join(map(str, shape))
    name = (f"trace_replay/{kind}{n_devices}" if kind != "mix"
            else f"trace_replay/mix_{split}")
    why = cards_missing(n_devices, device)
    if why:
        return BenchRecord(name=name, mesh=split,
                           knobs={"devices": n_devices, "split": split},
                           derived={"not_run": why, "ranks": n_devices})
    tr = cell_traces(n_devices, device)[split]
    base = cell_traces(1, device)["1x1"]
    res = replay(tr)
    measured_us = tr.measured_step_s * 1e6
    predicted_us = res.predicted_s * 1e6
    tok = tokens(device)
    return BenchRecord(
        name=name,
        mesh=split,
        us_per_call=TimingStats([t * 1e6 for t in tr.samples_s]),
        knobs={"devices": n_devices, "split": split, "kind": kind},
        derived={
            "measured_us": round(measured_us, 1),
            "predicted_us": round(predicted_us, 1),
            "rel_err": round(abs(predicted_us - measured_us) / measured_us,
                             6),
            "gate_rel_err": GATE_REL_ERR,
            "efficiency": round((tok / tr.measured_step_s)
                                / (tok / base.measured_step_s), 4),
            "dominant": res.dominant_lane,
            "n_events": len(tr.events),
            "critical_path_len": len(res.critical_path),
            "calibration_ratio": round(
                float(tr.meta.get("calibration_ratio", 0.0)), 4),
            "collective_bytes": tr.meta.get("collective_bytes", 0.0),
            "ici_bytes": tr.meta.get("ici_bytes", 0.0),
        },
    )


_TAGS = ("tier2", "measured", "trace_replay")


@scenario(
    "trace_replay/matrix", tags=_TAGS,
    paper_ref="Sec. V guidance loop (trace capture -> replay prediction)",
    workloads=[Workload(label=f"n{n}", arch=ARCH, knobs={"devices": n})
               for n in DEVICE_COUNTS])
def trace_replay_matrix(wl: Workload):
    """Identity replay of every captured scaling-matrix cell at this rank
    count; rel_err per cell is held to GATE_REL_ERR."""
    n = wl.knobs["devices"]
    for dp, tp in SPLITS[n]:
        kind = "dp" if tp == 1 else ("tp" if dp == 1 else "mix")
        yield _cell_record(kind, (dp, tp), n, _device(wl))


@scenario(
    "trace_replay/whatif", tags=_TAGS,
    paper_ref="Sec. V guidance loop (what-if split prediction)",
    workloads=[Workload(label="from-1x1", arch=ARCH, knobs={})])
def trace_replay_whatif(wl: Workload):
    """Cross-split what-if predictions from the 1x1 trace against every
    measured cell (reported, not gated)."""
    from repro_torch.trace import predict_split

    device = _device(wl)
    base = cell_traces(1, device)["1x1"]
    for n in DEVICE_COUNTS:
        why = cards_missing(n, device)
        cells = {} if why else cell_traces(n, device)
        for dp, tp in SPLITS[n]:
            split = f"{dp}x{tp}"
            pred = predict_split(base, (dp, tp))
            predicted_us = pred.predicted_s * 1e6
            derived = {"predicted_us": round(predicted_us, 1),
                       "dominant": pred.dominant_lane, "gated": False}
            us = 0.0
            if why:
                derived["not_run"] = why
            else:
                us = cells[split].measured_step_s * 1e6
                derived.update(
                    measured_us=round(us, 1),
                    ratio=round(predicted_us / us, 4),
                    rel_err=round(abs(predicted_us - us) / us, 4))
            yield BenchRecord(name=f"trace_replay/whatif_{split}",
                              mesh=split, us_per_call=us,
                              knobs={"devices": n, "split": split},
                              derived=derived)


@scenario(
    "trace_replay/advise", tags=_TAGS,
    paper_ref="Sec. V guidance loop (trace-calibrated mesh advisor)",
    workloads=[Workload(label="n8", arch=ARCH, knobs={"devices": 8})])
def trace_replay_advise(wl: Workload):
    """Split ranking at 8 devices: the card's peaks against the 1x1
    trace's measured rates, through the same advisor."""
    import dataclasses

    from repro_torch.configs import ARCHS, ShapeConfig, reduced
    from repro_torch.core.mesh_advisor import advise
    from repro_torch.trace import advise_from_trace

    n = wl.knobs["devices"]
    base = cell_traces(1, _device(wl))["1x1"]
    cfg = ARCHS[ARCH]
    if base.meta.get("reduce_kw"):
        cfg = reduced(cfg, **base.meta["reduce_kw"])
    cfg = dataclasses.replace(cfg, num_layers=int(base.meta["num_layers"]))
    shape = ShapeConfig("trace", "train", int(base.meta["seq"]),
                        int(base.meta["batch"]))
    candidates = [1, 2, 4, 8]
    analytic = advise(cfg, shape, n, candidates=candidates)
    traced = advise_from_trace(base, n, candidates=candidates)
    cal = base.calibration()
    yield BenchRecord(
        name=f"trace_replay/advise{n}",
        mesh="x".join(map(str, traced[0].mesh.shape)),
        knobs={"devices": n},
        derived={
            "analytic_best": "x".join(map(str, analytic[0].mesh.shape)),
            "traced_best": "x".join(map(str, traced[0].mesh.shape)),
            "analytic_step_us": round(analytic[0].step_s * 1e6, 1),
            "traced_step_us": round(traced[0].step_s * 1e6, 1),
            "traced_dominant": traced[0].dominant,
            "flops_per_s": round(cal["flops_per_s"], 1),
            "hbm_bytes_per_s": round(cal["hbm_bytes_per_s"], 1),
            "ici_bytes_per_s": round(cal["ici_bytes_per_s"], 1),
            "calibration_ratio": round(cal["calibration_ratio"], 4),
        },
    )


def serve_trace(device: str):
    """(trace, the engine's report, requests) of ``trace_replay/serve``'s
    burst: six 8-token prompts, 8 new tokens each, through a paged engine
    of 4 lanes and 64 pages of 4 tokens."""
    from repro_torch.bench.suites.serving import _params
    from repro_torch.data.pipeline import synth_requests
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.request import SimClock, WallClock
    from repro_torch.trace import TracingClock

    on_card = device.startswith("cuda")
    eng, cfg = build_engine(
        ARCH, batch=4, prompt_len=8, max_new_tokens=8, scheduler="paged",
        page_size=4, num_pages=64, use_reduced=not on_card,
        reduce_kw=SERVE_REDUCE, params=_params(device, not on_card),
        device=device)
    if on_card:
        eng.warmup(8)
    clk = TracingClock(WallClock() if on_card else
                       SimClock(prefill_cost_s=0.5, decode_cost_s=0.1))
    eng.clock = clk
    reqs = synth_requests(cfg, 6, 8, max_new_tokens=(8,), seed=0)
    report = eng.run(reqs)
    return clk.trace(f"serve/{ARCH}/paged", arch=ARCH), report, reqs


@scenario(
    "trace_replay/serve", tags=("tier2", "measured", "serving",
                                "trace_replay"),
    paper_ref="Sec. V guidance loop (serving dispatch trace)",
    workloads=[Workload(label="paged-burst", arch=ARCH, knobs={})])
def trace_replay_serve(wl: Workload):
    """Paged-engine burst under TracingClock: the recorded dispatch chain
    replays to the engine's busy time."""
    from repro_torch.trace import replay

    tr, report, reqs = serve_trace(_device(wl))
    tr.save(TRACE_DIR / f"{ARCH}-serve-paged.json")
    res = replay(tr)
    busy_us = tr.measured_step_s * 1e6
    predicted_us = res.predicted_s * 1e6
    yield BenchRecord(
        name="trace_replay/serve_paged",
        us_per_call=TimingStats(
            [ev.cost_s * 1e6 for ev in tr.events if ev.cost_s > 0]),
        knobs={"scheduler": "paged", "requests": len(reqs)},
        derived={
            "completed": report.completed,
            "busy_us": round(busy_us, 1),
            "predicted_us": round(predicted_us, 1),
            "rel_err": (abs(res.predicted_s - tr.measured_step_s)
                        / tr.measured_step_s if busy_us else 0.0),
            "n_events": len(tr.events),
            "prefill_dispatches": tr.meta["dispatches"].get("prefill", 0),
            "decode_dispatches": tr.meta["dispatches"].get("decode", 0),
        },
    )


@scenario(
    "trace_replay/serve_roles", tags=("tier2", "measured", "serving",
                                      "trace_replay", "disagg"),
    paper_ref="Sec. V guidance loop (per-role serving dispatch lanes)",
    workloads=[Workload(label="interleaved", arch=ARCH,
                        knobs={"scheduler": "paged"}),
               Workload(label="disaggregated", arch=ARCH,
                        knobs={"scheduler": "disaggregated"})])
def trace_replay_serve_roles(wl: Workload):
    """A chunked-prefill-heavy staggered stream under
    ``TracingClock(SimClock)``, both loop compositions: the trace's role
    lanes (``lane_seconds(by="role")``) beside the engine's decode-step
    stall distribution, before and after P/D disaggregation. The
    reference's reduced engine on either device."""
    import numpy as np

    from repro_torch.launch.serve import build_engine
    from repro_torch.serving import Request
    from repro_torch.serving.request import SimClock
    from repro_torch.trace import TracingClock, replay

    sched = wl.knobs["scheduler"]
    clk = TracingClock(SimClock())
    kw = (dict(prefill_workers=1, decode_workers=2)
          if sched == "disaggregated" else {})
    eng, cfg = build_engine(
        ARCH, batch=2, prompt_len=16, max_new_tokens=12,
        scheduler=sched, page_size=4, prefill_chunk_tokens=4, clock=clk,
        reduce_kw=SERVE_REDUCE, device=_device(wl), **kw)
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size, 16
                                        ).astype(np.int32),
                    max_new_tokens=12, arrival_s=45.0 * i)
            for i in range(8)]
    report = eng.run(reqs)
    s = report.summary()
    tr = clk.trace(f"serve/{ARCH}/{sched}-roles", arch=ARCH)
    tr.save(TRACE_DIR / f"{ARCH}-serve-{wl.label}-roles.json")
    res = replay(tr)
    lanes = tr.lane_seconds(by="role")
    yield BenchRecord(
        name=f"trace_replay/serve_{wl.label}_roles",
        us_per_call=TimingStats(
            [ev.cost_s * 1e6 for ev in tr.events if ev.cost_s > 0]),
        knobs={"scheduler": sched, "requests": len(reqs)},
        derived={
            "completed": report.completed,
            "busy_us": round(tr.measured_step_s * 1e6, 1),
            "predicted_us": round(res.predicted_s * 1e6, 1),
            "role_prefill_us": round(lanes.get("prefill", 0.0) * 1e6, 1),
            "role_decode_us": round(lanes.get("decode", 0.0) * 1e6, 1),
            "role_handoff_us": round(lanes.get("handoff", 0.0) * 1e6, 1),
            "decode_stall_p50_s": round(
                s.get("decode_stall_p50_s", 0.0), 4),
            "decode_stall_p95_s": round(
                s.get("decode_stall_p95_s", 0.0), 4),
            "handoffs": s.get("handoffs", 0),
            "gated": False,
        },
    )
