"""The port's serving suite (``repro_torch.bench.suites.serving``) against
``benchmarks/bench_serving.py``: the nine Tier-2 scenarios on the
reference's reduced cell (``reduced=True``), the port on the CPU.

* Scenarios under ``SimClock`` (prefix, replay, chaos, P/D): every
  derived field, TTFT and per-token latency percentile equal (times to
  1e-9: they are schedule-determined).
* Wall-clock scenarios: the same record names and derived keys; with
  burst arrivals the schedule does not depend on the host's speed, so
  ``completed``, ``decode_steps``, ``prefills``, ``peak_concurrency``,
  occupancy, slot balance and the page fields are equal. Under Poisson
  offered load how many arrivals land during a decode step depends on
  each side's time per step, so those wall-clock records hold
  ``completed`` and ``prefills``; their workloads are then run again on
  both sides with the arrivals fixed against a ``SimClock`` (every
  dispatch costs the same on both), and there every structural field,
  the makespan and the greedy tokens per rid are equal.
"""
import dataclasses

import pytest
import torch

import repro_torch.bench.suites  # noqa: F401  (registers the scenarios)
from repro_torch.bench import BenchRunner, ListSink, env_fingerprint, select
from repro_torch.bench import __main__ as bench_main

torch.set_num_threads(2)
SIMCLOCK = ("serving/prefix_shared_burst", "serving/multi_turn_replay",
            "serving/chaos_soak", "serving/pd_disaggregation")
SCENARIOS = ("serving/goodput_vs_load", "serving/static_vs_continuous",
             "serving/paged_vs_monolithic", "serving/paged_page_size",
             "serving/prefix_shared_burst", "serving/multi_turn_replay",
             "serving/chaos_soak", "serving/pd_disaggregation",
             "serving/slot_balance")
STRUCTURAL = ("completed", "decode_steps", "prefills", "peak_concurrency",
              "occupancy", "slot_balance", "page_size", "num_pages",
              "page_occupancy_mean", "page_occupancy_peak",
              "fragmentation_mean", "fragmentation_peak",
              "pages_high_water", "failed_allocs", "admission_blocked_steps")
LOADED = ("completed", "prefills")


@pytest.fixture(scope="module")
def records():
    import benchmarks.bench_serving  # noqa: F401  (the JAX registry)
    from repro.bench import BenchRunner as JaxRunner
    from repro.bench import ListSink as JaxSink
    from repro.bench import select as jax_select

    ref = JaxSink()
    assert not JaxRunner(sinks=[ref]).run(jax_select(only="serving")).failures
    ours = ListSink()
    scens = [dataclasses.replace(s, workloads=tuple(
        dataclasses.replace(w, knobs={**w.knobs, "reduced": True,
                                      "device": "cpu"})
        for w in s.workloads)) for s in select(only="serving")]
    out = BenchRunner(sinks=[ours], env=env_fingerprint("cpu")).run(scens)
    assert not out.failures
    return ({r.name: r for r in ref.records},
            {r.name: r for r in ours.records})


def test_the_nine_scenarios_are_listed(capsys):
    assert [s.name for s in select(only="serving")] == list(SCENARIOS)
    assert bench_main.main(["--device", "cpu", "--only", "serving",
                            "--list"]) == 0
    listed = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert listed == list(SCENARIOS)


@pytest.mark.parametrize("scen", SCENARIOS)
def test_records_match_the_reference(records, scen):
    ref, ours = records
    want = {n: r for n, r in ref.items() if r.scenario == scen}
    got = {n: r for n, r in ours.items() if r.scenario == scen}
    assert want and sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.status == w.status == "ok"
        assert g.derived.keys() == w.derived.keys()
        assert g.knobs["device"] == "cpu" and g.knobs["reduced"]
        if scen in SIMCLOCK:
            assert g.derived == w.derived
            for f in ("ttft_us", "us_per_call", "p50_us", "p95_us"):
                assert getattr(g, f) == pytest.approx(getattr(w, f),
                                                      rel=1e-9, abs=1e-9), f
        else:
            loaded = g.knobs.get("offered_rps", 0.0) > 0
            keys = [k for k in (LOADED if loaded else STRUCTURAL)
                    if k in w.derived]
            assert {k: g.derived[k] for k in keys} == {
                k: w.derived[k] for k in keys}


# the Poisson records' workloads: record -> (scheduler, offered rps, page
# size), each engine as the suite builds it
LOADED_CELLS = {"goodput_load16": ("continuous", 16.0, None),
                "goodput_load64": ("continuous", 64.0, None),
                "paged_ps4_load64": ("paged", 64.0, 4),
                "paged_ps16_load64": ("paged", 64.0, 16)}


def _loaded_kw(sched, ps):
    from repro_torch.bench.suites import serving as s
    if sched == "continuous":
        return dict(batch=s.SLOTS, prompt_len=s.PROMPT,
                    max_new_tokens=s.MAX_BUDGET, scheduler=sched,
                    reduce_kw=s.REDUCE)
    return dict(batch=s.PAGED_LANES, prompt_len=s.PROMPT,
                max_new_tokens=s.MAX_BUDGET, scheduler=sched, page_size=ps,
                num_pages=s.BUDGET_TOKENS // ps,
                prefill_chunk_tokens=s.PROMPT // 2, reduce_kw=s.REDUCE)


@pytest.mark.parametrize("name", LOADED_CELLS)
def test_loaded_workloads_match_the_reference_with_arrivals_fixed(name):
    import jax
    import numpy as np

    from repro.data.pipeline import synth_requests as jax_synth_requests
    from repro.launch.serve import build_engine as jax_build_engine
    from repro.serving import SimClock as JaxSimClock
    from repro_torch.bench.suites import serving as s
    from repro_torch.data.pipeline import synth_requests
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving import SimClock

    sched, rate, ps = LOADED_CELLS[name]
    kw = _loaded_kw(sched, ps)
    jeng, jcfg = jax_build_engine(s.ARCH, clock=JaxSimClock(), **kw)
    want = jeng.run(jax_synth_requests(jcfg, s.N_REQ, s.PROMPT,
                                       max_new_tokens=(4, 12),
                                       rate_per_s=rate, seed=0))
    params = jax.tree.map(np.asarray, jeng.params)
    eng, cfg = build_engine(s.ARCH, clock=SimClock(), params=params,
                            device="cpu", **kw)
    got = eng.run(synth_requests(cfg, s.N_REQ, s.PROMPT,
                                 max_new_tokens=(4, 12), rate_per_s=rate,
                                 seed=0))
    assert ({m.rid: [int(t) for t in m.tokens] for m in got.metrics}
            == {m.rid: [int(t) for t in m.tokens] for m in want.metrics})
    gs, ws = got.summary(), want.summary()
    keys = [k for k in STRUCTURAL + ("makespan_s",) if k in ws]
    assert {"completed", "decode_steps", "prefills", "peak_concurrency",
            "makespan_s"} <= set(keys)
    if ps:
        assert len(keys) == len(STRUCTURAL) + 1
    for k in keys:
        assert gs[k] == pytest.approx(ws[k], abs=1e-9), k
    # arrivals land during the run, so the schedule is really loaded
    assert max(m.arrival_s for m in want.metrics) > 0
