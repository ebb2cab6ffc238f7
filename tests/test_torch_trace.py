"""repro_torch.trace against repro.trace: the counterparts of the
reference's trace tests (schema round trip and validation, DAG replay,
what-if monotonicity, the serving TracingClock seam, cross-split
prediction, one real 2-rank matrix cell within the 25% bound), then the
port's functions against the JAX package's on the same summary and the
same (TPU) rates, and traces crossing between the two packages."""
import json
import random

import numpy as np
import pytest
import torch

import repro.trace as jtrace
from repro.core.roofline import (HBM_BW, HBM_PER_CHIP, ICI_BW_PER_LINK,
                                 PEAK_FLOPS_BF16)
from repro_torch.core.roofline import Chip
from repro_torch.serving import ContinuousEngine, Request, SimClock
from repro_torch.trace import (Trace, TraceError, TraceEvent, TracingClock,
                               advise_from_trace, capture_matrix_cell,
                               dag_from_cost_summary, load_trace,
                               predict_split, replay, scale_kind, scale_op,
                               set_cost, toposort)

# the JAX package's rates: it costs every step at its bf16 peak
TPU = Chip(name="tpu (the JAX package's constants)",
           peak_flops={"bfloat16": PEAK_FLOPS_BF16,
                       "float32": PEAK_FLOPS_BF16},
           hbm_bw=HBM_BW, hbm_bytes=HBM_PER_CHIP, link_bw=ICI_BW_PER_LINK)

VOCAB = 17
SPAN = 16


def _diamond(costs=(0.0, 3.0, 5.0, 1.0)):
    """root -> {left, right} -> sink; right is the critical branch."""
    a, b, c, d = costs
    return Trace(name="diamond", events=[
        TraceEvent("root", "host", "dispatch", a),
        TraceEvent("left", "compute", "dot", b, deps=("root",)),
        TraceEvent("right", "memory", "copy", c, deps=("root",)),
        TraceEvent("sink", "host", "sync", d, deps=("left", "right")),
    ])


def _train_like(compute=4.0, memory=2.0, cls=Trace, event=TraceEvent):
    """A minimal capture_train_trace-shaped trace predict_split accepts."""
    a, b, c, d = 0.0, compute, memory, 0.0
    tr = cls(name="diamond", events=[
        event("root", "host", "dispatch", a),
        event("left", "compute", "dot", b, deps=("root",)),
        event("right", "memory", "copy", c, deps=("root",)),
        event("sink", "host", "sync", d, deps=("left", "right")),
    ])
    tr.meta.update({
        "split": [1, 1], "param_count": 1e5, "d_model": 128, "layers": 2,
        "tokens": 512, "bytes": 1.2e6, "flops": 3e8, "calibration_ratio": 50.0,
    })
    tr.measured_step_s = max(compute, memory)
    tr.samples_s = [tr.measured_step_s]
    return tr


# ------------------------------------------------------------------ schema
def test_trace_json_round_trip_is_byte_stable(tmp_path):
    tr = _diamond()
    tr.meta["calibration_ratio"] = 2.5
    back = Trace.from_json(tr.to_json())
    assert back.to_json() == tr.to_json()
    assert [e.eid for e in back.events] == ["root", "left", "right", "sink"]
    assert back.events[3].deps == ("left", "right")
    p = tr.save(tmp_path / "traces" / "diamond.json")
    loaded = load_trace(p)
    assert loaded.to_json() == tr.to_json()
    # the env fingerprint rides along like BenchRecord's
    assert "python" in loaded.env


def test_validate_rejects_structural_damage():
    dup = _diamond()
    dup.events.append(TraceEvent("left", "compute", "dot", 1.0))
    with pytest.raises(TraceError, match="duplicate"):
        dup.validate()
    neg = _diamond((0.0, -1.0, 5.0, 0.0))
    with pytest.raises(TraceError, match="negative"):
        neg.validate()
    dangling = _diamond()
    dangling.events[1] = TraceEvent("left", "compute", "dot", 3.0,
                                    deps=("ghost",))
    with pytest.raises(TraceError, match="unknown"):
        dangling.validate()


def test_newer_schema_version_is_refused():
    d = _diamond().to_dict()
    d["version"] = 999
    with pytest.raises(TraceError, match="newer"):
        Trace.from_dict(d)


# ------------------------------------------------------------------ replay
def test_toposort_respects_deps_in_any_input_order():
    events = list(reversed(_diamond().events))
    order = [ev.eid for ev in toposort(events)]
    assert order.index("root") < order.index("left") < order.index("sink")
    assert order.index("root") < order.index("right") < order.index("sink")


def test_toposort_names_cycle_members():
    cyc = [TraceEvent("a", "compute", deps=("b",)),
           TraceEvent("b", "compute", deps=("a",))]
    with pytest.raises(TraceError, match="cycle.*'a', 'b'"):
        toposort(cyc)


def test_identity_replay_is_earliest_start_over_the_dag():
    res = replay(_diamond())
    # parallel branches: sink starts when the slower branch finishes
    assert res.predicted_s == pytest.approx(6.0)
    assert res.finish_s["left"] == pytest.approx(3.0)
    assert res.finish_s["right"] == pytest.approx(5.0)
    assert res.critical_path == ["root", "right", "sink"]
    assert res.dominant_lane == "memory"


SUMMARY = {
    "flops_by_op": {"dot": 8e9, "add": 1e9, "exp": 5e8},
    "bytes_by_op": {"copy": 2e9, "fusion": 1e9},
    "collective_ici_by_op": {"all-reduce": 3e8},
}


def test_replay_matches_recorded_step_on_decomposed_dag():
    """The capture layer's invariant the identity gate relies on: a DAG
    built by dag_from_cost_summary replays to the measured step."""
    measured = 0.125
    events, extras = dag_from_cost_summary(SUMMARY, measured, ops_per_lane=2)
    tr = Trace(name="cell", events=events, measured_step_s=measured,
               meta=extras)
    assert replay(tr).predicted_s == pytest.approx(measured, rel=1e-9)
    # the tail "other" event keeps lane totals exact despite ops_per_lane
    assert any(ev.op == "other" for ev in events)
    assert extras["calibration_ratio"] > 0


def test_empty_summary_falls_back_to_opaque_step():
    events, extras = dag_from_cost_summary({}, 0.5)
    tr = Trace(name="opaque", events=events, measured_step_s=0.5)
    assert replay(tr).predicted_s == pytest.approx(0.5)
    assert extras["calibration_ratio"] == 1.0


# ----------------------------------------------------------------- what-if
def test_edit_monotonicity_halving_never_increases_prediction():
    base = replay(_diamond()).predicted_s
    for edit in (scale_op("copy", 0.5), scale_kind("memory", 0.5),
                 scale_op("dot", 0.5), set_cost("right", 0.0)):
        assert replay(_diamond(), edits=[edit]).predicted_s <= base


def test_whatif_edit_can_shift_the_critical_path():
    # halving the memory branch (5.0 -> 2.5) hands the critical path to
    # the 3.0s compute branch; the 1.0s sink still runs after it
    res = replay(_diamond(), edits=[scale_kind("memory", 0.5)])
    assert res.predicted_s == pytest.approx(4.0)
    assert res.critical_path == ["root", "left", "sink"]
    assert res.dominant_lane == "compute"


def test_negative_edit_is_refused():
    with pytest.raises(TraceError, match="negative"):
        replay(_diamond(), edits=[scale_op("copy", -1.0)])


def test_predict_split_requires_train_capture_meta():
    with pytest.raises(TraceError, match="meta lacks"):
        predict_split(_diamond(), (2, 1))


def test_predict_split_scales_lanes_by_first_principles():
    tr = _train_like(compute=4.0, memory=2.0)
    same = predict_split(tr, (1, 1))
    # identity split: no collectives, lanes unchanged -> compute-bound
    assert same.predicted_s == pytest.approx(4.0)
    dp2 = predict_split(tr, (2, 1))
    # compute halves; DP adds a gradient all-reduce, so the prediction
    # can never undercut the pure-compute floor
    assert dp2.finish_s["compute"] == pytest.approx(2.0)
    assert dp2.predicted_s >= 2.0
    assert dp2.finish_s["collective"] > 0.0
    tp2 = predict_split(tr, (1, 2))
    assert tp2.finish_s["compute"] == pytest.approx(2.0)
    assert tp2.finish_s["collective"] > 0.0
    with pytest.raises(TraceError, match="bad split"):
        predict_split(tr, (0, 2))


# ---------------------------------------------------------- serving capture
def _stub_prefill(params, batch, cache_span):
    """Flat logits except a spike at token 1; caches with batch axis 1."""
    B = batch["tokens"].shape[0]
    logits = torch.zeros((B, 1, VOCAB))
    logits[:, :, 1] = 100.0
    return logits, {"layers": {"k": torch.zeros((1, B, cache_span, 2))}}


def _stub_decode(params, caches, tok, pos):
    """Next token = pos + 1 (clipped into the vocab), for a scalar or a
    (B,) position."""
    pos_v = torch.as_tensor(pos).reshape(-1).expand(tok.shape[0])
    lg = torch.nn.functional.one_hot(
        torch.clamp(pos_v + 1, max=VOCAB - 1).long(), VOCAB).float() * 100.0
    return lg[:, None, :], caches


def _stub_cache_init(batch, max_len, dtype=torch.float32):
    return {"layers": {"k": torch.zeros((1, batch, max_len, 2),
                                        dtype=dtype)}}


def _stub_requests(n, prompt_len=4, budgets=(6,)):
    return [Request(rid=i, prompt=np.full(prompt_len, 2, np.int32),
                    max_new_tokens=budgets[i % len(budgets)])
            for i in range(n)]


def test_tracing_clock_records_busy_time_only():
    clk = TracingClock(SimClock(prefill_cost_s=10.0, decode_cost_s=1.0))
    clk.charge("prefill")
    clk.wait_until(clk.now() + 100.0)  # idle gap must not become an event
    clk.charge("decode", n=3)
    tr = clk.trace("serve/unit", n_devices=1)
    assert [ev.kind for ev in tr.events] == ["prefill", "decode"]
    assert tr.events[1].deps == (tr.events[0].eid,)
    assert tr.measured_step_s == pytest.approx(13.0)
    assert tr.meta["dispatches"] == {"prefill": 1, "decode": 1}
    # the dispatch chain replays to the engine's busy time exactly
    assert replay(tr).predicted_s == pytest.approx(13.0)


def test_tracing_clock_traces_a_real_engine_run():
    """TracingClock at the clock seam of the port's ContinuousEngine
    captures every dispatch without touching engine code."""
    clk = TracingClock(SimClock(prefill_cost_s=10.0, decode_cost_s=1.0))
    eng = ContinuousEngine(_stub_prefill, _stub_decode, None,
                           _stub_cache_init, slots=2, cache_span=SPAN,
                           clock=clk, device="cpu")
    report = eng.run(_stub_requests(3, budgets=(4,)))
    tr = clk.trace("serve/continuous")
    assert sum(tr.meta["dispatches"].values()) == len(tr.events)
    assert tr.meta["dispatches"]["prefill"] == report.prefills
    assert replay(tr).predicted_s == pytest.approx(tr.measured_step_s)


# --------------------------------------------------- real capture (2 ranks)
@pytest.fixture(scope="module")
def tp2_trace():
    """One real 2-rank scaling-matrix cell, captured on gloo ranks."""
    traces = capture_matrix_cell(
        2, [(1, 2)], batch=4, seq=16,
        reduce_kw=dict(layers=2, d_model=64, d_ff=128, vocab=128),
        iters=3, warmup=1)
    assert len(traces) == 1
    return traces[0]


def test_matrix_cell_capture_replays_within_the_bound(tp2_trace):
    """Rank capture -> JSON transport -> identity replay within 25%."""
    tr = tp2_trace
    assert (tr.mesh, tr.n_devices) == ("1x2", 2)
    assert tr.meta["split"] == [1, 2]
    res = replay(tr)
    rel = abs(res.predicted_s - tr.measured_step_s) / tr.measured_step_s
    assert rel <= 0.25, f"identity replay drifted {rel:.3f} from measured"
    # a TP cell has a populated collective lane (the tensor-parallel
    # all-reduces of the sharded step, counted with their group's size)
    assert tr.lane_seconds().get("collective", 0.0) > 0.0
    assert tr.meta["ici_bytes"] > 0
    # and the trace-calibrated advisor runs off this trace alone
    ranked = advise_from_trace(tr, 2)
    assert ranked and ranked[0].mesh.shape in [(2, 1), (1, 2)]
    assert ranked[0].step_s > 0.0


def test_capture_train_trace_requires_enough_ranks():
    from repro_torch.trace.capture import capture_train_trace
    with pytest.raises(RuntimeError, match="needs 64 ranks"):
        capture_train_trace(split=(8, 8), iters=1, warmup=0, device="cpu")


def test_trace_json_survives_line_transport():
    """The ranks' transport contract: one trace per line."""
    tr = _train_like()
    line = tr.to_json()
    assert "\n" not in line
    assert json.loads(line)["name"] == tr.name


# ------------------------------------------- against the JAX package's
def _random_summary(seed):
    rng = random.Random(seed)
    ops = ["dot", "add", "exp", "mul", "copy", "fusion", "reduce", "conv"]
    return {
        "flops_by_op": {o: rng.uniform(1e6, 1e10) for o in
                        rng.sample(ops, rng.randint(1, 8))},
        "bytes_by_op": {o: rng.uniform(1e6, 1e9) for o in
                        rng.sample(ops, rng.randint(0, 8))},
        "collective_ici_by_op": {o: rng.uniform(1e5, 1e8) for o in
                                 rng.sample(["all-reduce", "all-gather",
                                             "reduce-scatter"],
                                            rng.randint(0, 3))},
    }


def _close(a, b, tol=1e-12):
    return abs(a - b) <= tol * max(abs(a), abs(b), 1e-300)


def _same_events(ours, theirs):
    assert [(e.eid, e.kind, e.op, e.deps) for e in ours] == \
        [(e.eid, e.kind, e.op, e.deps) for e in theirs]
    for a, b in zip(ours, theirs):
        assert _close(a.cost_s, b.cost_s), (a.eid, a.cost_s, b.cost_s)
        assert a.meta.keys() == b.meta.keys()
        for k in a.meta:
            assert _close(a.meta[k], b.meta[k])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ops_per_lane", [1, 2, 6])
def test_dag_replay_and_predict_split_equal_the_jax_functions(seed,
                                                              ops_per_lane):
    summary = _random_summary(seed)
    measured = 0.05 + 0.01 * seed
    ours, ours_x = dag_from_cost_summary(summary, measured,
                                         ops_per_lane=ops_per_lane, chip=TPU,
                                         dtype="bfloat16")
    theirs, theirs_x = jtrace.dag_from_cost_summary(
        summary, measured, ops_per_lane=ops_per_lane)
    _same_events(ours, theirs)
    assert ours_x.keys() == theirs_x.keys()
    for k in ours_x:
        assert _close(ours_x[k], theirs_x[k])
    meta = {"split": [1, 2], "param_count": 3e5 * (seed + 1),
            "d_model": 128, "layers": 2, "tokens": 512,
            "bytes": 2e8 * (seed + 1), "flops": 7e9, "model_flops": 5e9,
            "ici_bytes": sum(summary["collective_ici_by_op"].values()),
            **ours_x}
    tr = Trace(name="t", events=ours, measured_step_s=measured,
               samples_s=[measured], meta=dict(meta), n_devices=2)
    jtr = jtrace.Trace(name="t", events=theirs, measured_step_s=measured,
                       samples_s=[measured], meta=dict(meta), n_devices=2)
    r, jr = replay(tr), jtrace.replay(jtr)
    assert _close(r.predicted_s, jr.predicted_s)
    assert r.critical_path == jr.critical_path
    for eid in jr.finish_s:
        assert _close(r.finish_s[eid], jr.finish_s[eid])
    cal, jcal = tr.calibration(TPU), jtr.calibration()
    assert cal.keys() == jcal.keys()
    for k in cal:
        assert _close(cal[k], jcal[k])
    for split in ((1, 1), (2, 1), (1, 2), (4, 2), (2, 4), (8, 1)):
        p = predict_split(tr, split, chip=TPU)
        jp = jtrace.predict_split(jtr, split)
        assert _close(p.predicted_s, jp.predicted_s), split
        assert p.critical_path == jp.critical_path
        for eid in jp.finish_s:
            assert _close(p.finish_s[eid], jp.finish_s[eid])


def test_traces_cross_between_the_packages(tmp_path, tp2_trace):
    """A trace the port writes loads and validates under the reference's
    reader and replays to the same prediction; and the reverse."""
    path = tp2_trace.save(tmp_path / "ours.json")
    theirs = jtrace.Trace.from_json(path.read_text())
    theirs.validate()
    assert theirs.to_json() == tp2_trace.to_json()
    assert _close(jtrace.replay(theirs).predicted_s,
                  replay(tp2_trace).predicted_s)
    assert _close(jtrace.predict_split(theirs, (2, 1)).predicted_s,
                  predict_split(tp2_trace, (2, 1), chip=TPU).predicted_s)

    jtr = _train_like(cls=jtrace.Trace, event=jtrace.TraceEvent)
    jpath = jtr.save(tmp_path / "theirs.json")
    back = load_trace(jpath)
    assert back.to_json() == jtr.to_json()
    assert _close(replay(back).predicted_s,
                  jtrace.replay(jtr).predicted_s)
    assert _close(predict_split(back, (2, 4), chip=TPU).predicted_s,
                  jtrace.predict_split(jtr, (2, 4)).predicted_s)


def test_the_trace_cli(tmp_path, capsys):
    """``python -m repro_torch.launch.trace``: capture on the CPU (a 1x1
    split in this process), then replay (identity and edited), whatif and
    advise from the saved file, each printing one JSON object; on the card
    by default, which raises without one."""
    from repro_torch.launch import trace as cli

    out = tmp_path / "t.json"
    assert cli.main(["capture", "--split", "1x1", "--batch", "2", "--seq",
                     "16", "--iters", "2", "--out", str(out), "--device",
                     "cpu"]) == 0
    cap = json.loads(capsys.readouterr().out)
    assert cap["name"] == "train/granite-3-8b/1x1" and cap["events"] > 3
    assert cli.main(["replay", str(out)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["identity_rel_err"] <= 1e-6
    assert cli.main(["replay", str(out), "--scale-kind", "compute=0.5"]) == 0
    assert json.loads(capsys.readouterr().out)["predicted_us"] <= \
        rep["predicted_us"]
    assert cli.main(["whatif", str(out), "--split", "2x1"]) == 0
    assert json.loads(capsys.readouterr().out)["split"] == "2x1"
    assert cli.main(["advise", str(out), "--devices", "4"]) == 0
    ranking = json.loads(capsys.readouterr().out)["ranking"]
    assert {r["split"] for r in ranking} <= {"4x1", "2x2", "1x4"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            cli.main(["capture", "--out", str(tmp_path / "c.json")])
