"""The port's fault injection against the JAX package's.

* ``FaultPlan.default(seed)`` written by both packages' ``to_json`` is the
  same file, and reads back through ``from_json`` / ``resolve_fault_plan``.
* The chaos burst of ``benchmarks/bench_serving.py`` (``chaos_soak``:
  deadlines, a half/half priority mix, 13 pages of 4 tokens over 2 lanes,
  ``SimClock``) through the port's paged engine and the reference's, with
  and without the default plan, on the reference's weights (bridged):
  outcomes, fault counts, recovery steps, requeues, preemptions and greedy
  tokens per rid identical; ``results/findings.md`` §Robustness: 8/8
  completed, 5/5 faults recovered, 0 pages leaked, makespans 218 / 223 s.
* The leak detector's self-test, as ``tools/ci_checks.py chaos-parity``
  does it: with ``_release_pages`` a no-op the report must show leaked
  pages.
* ``warmup`` leaves the fault schedule unconsumed.
"""
import json

import numpy as np
import pytest
import torch

import jax

from repro.launch.serve import build_engine as jax_build_engine
from repro.serving import FaultPlan as JaxFaultPlan
from repro.serving import Request as JaxRequest
from repro.serving import SimClock as JaxSimClock
from repro_torch.launch.serve import build_engine
from repro_torch.serving import (FAULT_KINDS, Fault, FaultInjector, FaultPlan,
                                 PageAllocator, PagedEngine, Request,
                                 SimClock, resolve_fault_plan)

torch.set_num_threads(2)
REDUCE = dict(layers=2, d_model=64, vocab=128, d_ff=128)
CHAOS = dict(batch=2, prompt_len=18, max_new_tokens=6, scheduler="paged",
             page_size=4, num_pages=13, prefill_chunk_tokens=4,
             reduce_kw=REDUCE)


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_default_plan_matches_jax(tmp_path, seed):
    ours = FaultPlan.default(seed).to_json(tmp_path / "ours.json")
    ref = JaxFaultPlan.default(seed).to_json(tmp_path / "ref.json")
    assert ours.read_text() == ref.read_text()
    back = FaultPlan.from_json(ours)
    assert back == FaultPlan.default(seed)
    assert resolve_fault_plan(str(ours)) == back
    assert resolve_fault_plan("default", seed) == back
    assert resolve_fault_plan("none") is None and resolve_fault_plan(None) \
        is None
    assert {f.kind for f in back.faults} == set(FAULT_KINDS)
    assert json.loads(ours.read_text())["seed"] == seed


def test_fault_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault(step=0, kind="meteor")


def test_poison_is_detected_and_healed():
    alloc = PageAllocator(num_pages=6, page_size=4)
    alloc.allocate(1, 8)
    inj = FaultInjector(FaultPlan(faults=[Fault(step=0, kind="poison_pool")]))
    inj.begin_step(0, alloc, SimClock())
    with pytest.raises(AssertionError):
        alloc.check()
    assert inj.heal(alloc) and not inj.heal(alloc)
    alloc.check()
    assert (inj.injected, inj.recoveries, inj.recovery_steps()) == (1, 1, [0])


def _slo_burst(req_cls, vocab, n=8):
    rng = np.random.default_rng(13)
    return [req_cls(rid=i,
                    prompt=rng.integers(1, vocab, 6 + 2 * (i % 3)
                                        ).astype(np.int32),
                    max_new_tokens=5 + (i % 2), arrival_s=0.5 * i,
                    deadline_s=600.0, priority=2 * (i % 2))
            for i in range(n)]


@pytest.fixture(scope="module")
def jax_runs():
    eng, cfg = jax_build_engine("granite-3-8b", clock=JaxSimClock(), **CHAOS)
    out = {}
    for faulted in (False, True):
        eng.fault_plan = JaxFaultPlan.default(0) if faulted else None
        out[faulted] = eng.run(_slo_burst(JaxRequest, cfg.vocab_size))
    return out, jax.tree.map(np.asarray, eng.params)


def _view(report):
    per_rid = {m.rid: (m.outcome, m.finished, m.new_tokens, m.retries,
                       m.preemptions, m.first_token_s, m.finish_s,
                       [int(t) for t in m.tokens])
               for m in report.metrics}
    s = report.summary()
    keys = ("completed", "makespan_s", "decode_steps", "prefills",
            "preemption_events", "requeues", "retries", "n_failed",
            "n_timed_out", "n_preempted", "admission_blocked_steps",
            "faults_injected", "fault_recoveries", "recovery_steps_mean",
            "recovery_steps_max")
    return per_rid, {k: s.get(k) for k in keys}, report.fault_recovery_steps


@pytest.mark.parametrize("faulted", [False, True], ids=["baseline", "chaos"])
def test_chaos_burst_matches_jax(jax_runs, faulted):
    want, params = jax_runs
    eng, cfg = build_engine("granite-3-8b", clock=SimClock(), params=params,
                            device="cpu",
                            fault_plan=FaultPlan.default(0) if faulted
                            else None, **CHAOS)
    got = eng.run(_slo_burst(Request, cfg.vocab_size))
    assert _view(got) == _view(want[faulted])
    assert got.pages_leaked == 0 == want[faulted].pages_leaked


def test_chaos_reproduces_the_findings(jax_runs):
    _, params = jax_runs
    eng, cfg = build_engine("granite-3-8b", clock=SimClock(), params=params,
                            device="cpu", **CHAOS)
    base = eng.run(_slo_burst(Request, cfg.vocab_size))
    eng.fault_plan = FaultPlan.default(0)
    chaos = eng.run(_slo_burst(Request, cfg.vocab_size))
    s = chaos.summary()
    assert (base.completed, chaos.completed) == (8, 8)
    assert (s["faults_injected"], s["fault_recoveries"]) == (5, 5)
    assert (s["recovery_steps_mean"], s["recovery_steps_max"]) == (1.8, 6)
    assert (s["requeues"], s["preemption_events"]) == (2, 1)
    assert (base.makespan_s, chaos.makespan_s) == (218.0, 223.0)
    assert base.pages_leaked == chaos.pages_leaked == 0
    want = {m.rid: [int(t) for t in m.tokens] for m in base.metrics}
    for m in chaos.metrics:
        if m.outcome == "completed":
            assert [int(t) for t in m.tokens] == want[m.rid]


def test_leak_detector_trips_when_release_is_disabled(jax_runs,
                                                      monkeypatch):
    """Break the one page-release seam: uniform priorities and no plan, so
    nothing requeues, and a pool big enough that the leaky run completes;
    the leak count must then be positive."""
    _, params = jax_runs
    eng, cfg = build_engine("granite-3-8b", clock=SimClock(), params=params,
                            device="cpu", **{**CHAOS, "num_pages": 64})
    reqs = _slo_burst(Request, cfg.vocab_size, n=5)
    for r in reqs:
        r.priority = 0
    assert eng.run(reqs).pages_leaked == 0
    monkeypatch.setattr(PagedEngine, "_release_pages",
                        lambda self, alloc, rid: None)
    assert eng.run(reqs).pages_leaked > 0


def test_warmup_leaves_the_plan_unconsumed(jax_runs, monkeypatch):
    _, params = jax_runs
    plan = FaultPlan.default(0)
    eng, cfg = build_engine("granite-3-8b", clock=SimClock(), params=params,
                            device="cpu", fault_plan=plan, **CHAOS)
    made = []
    real = FaultInjector.__init__

    def counting(self, p):
        made.append(p)
        real(self, p)

    monkeypatch.setattr(FaultInjector, "__init__", counting)
    eng.warmup(8)
    assert made == [] and eng.fault_plan is plan
    s = eng.run(_slo_burst(Request, cfg.vocab_size)).summary()
    assert made == [plan]
    assert s["faults_injected"] == s["fault_recoveries"] == 5
