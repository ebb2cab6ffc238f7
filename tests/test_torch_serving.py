"""The port's serving engines against the JAX package's, on the workload
of ``tools/ci_checks.py::check_paged_parity``: reduced granite-3-8b, a
mixed-budget burst plus a second wave with a shorter prompt (so chunked
prefill ends on a partial chunk), under ``SimClock``. The port's engines
serve the JAX engines' own weights (numpy, through the bridge).

Held identical, not close: per-rid greedy tokens, and every schedule
counter the SimClock run produces (decode steps, prefills, peak
concurrency, page occupancy and fragmentation).
"""
import numpy as np
import pytest
import torch

import jax

from repro.data.pipeline import synth_requests as jax_synth_requests
from repro.launch.serve import build_engine as jax_build_engine
from repro.serving import SimClock as JaxSimClock
from repro_torch.configs import get_arch, reduced
from repro_torch.data.pipeline import synth_requests
from repro_torch.launch.serve import build_engine
from repro_torch.serving import SimClock

torch.set_num_threads(2)
REDUCE = dict(layers=2, d_model=64, vocab=128, d_ff=128)
PROMPT, BUDGET, SLOTS, PS = 8, 24, 4, 8
SPAN = PROMPT + BUDGET
ENGINES = {
    "continuous": dict(batch=SLOTS, scheduler="continuous"),
    "paged": dict(batch=2 * SLOTS, scheduler="paged", page_size=PS,
                  num_pages=SLOTS * SPAN // PS,
                  prefill_chunk_tokens=PROMPT // 2),
}
SCHEDULE_FIELDS = ("completed", "total_new_tokens", "makespan_s",
                   "decode_steps", "prefills", "peak_concurrency",
                   "occupancy", "ttft_p50_s", "ttft_p95_s")
PAGE_FIELDS = ("page_occupancy_mean", "page_occupancy_peak",
               "fragmentation_mean", "fragmentation_peak",
               "pages_high_water", "admission_blocked_steps")


def _workload(synth, cfg):
    reqs = synth(cfg, 8, PROMPT, max_new_tokens=(2, BUDGET))
    short = synth(cfg, 4, PROMPT - 3, max_new_tokens=5, seed=1)
    for r in short:
        r.rid += 100
    return reqs + short


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engines' reports and their (shared) parameters."""
    out = {}
    params = None
    for name, kw in ENGINES.items():
        eng, jcfg = jax_build_engine(
            "granite-3-8b", prompt_len=PROMPT, max_new_tokens=BUDGET,
            reduce_kw=REDUCE, clock=JaxSimClock(), **kw)
        out[name] = eng.run(_workload(jax_synth_requests, jcfg))
        params = jax.tree.map(np.asarray, eng.params)
    return out, params


def _tokens(report):
    return {m.rid: [int(t) for t in m.tokens] for m in report.metrics}


@pytest.mark.parametrize("scheduler", list(ENGINES))
def test_engine_matches_jax_engine(jax_runs, scheduler):
    jax_reports, params = jax_runs
    eng, cfg = build_engine("granite-3-8b", prompt_len=PROMPT,
                            max_new_tokens=BUDGET, reduce_kw=REDUCE,
                            clock=SimClock(), params=params, device="cpu",
                            **ENGINES[scheduler])
    got = eng.run(_workload(synth_requests, cfg))
    want = jax_reports[scheduler]
    assert _tokens(got) == _tokens(want)
    gs, ws = got.summary(), want.summary()
    fields = SCHEDULE_FIELDS + (PAGE_FIELDS if scheduler == "paged" else ())
    assert {f: gs[f] for f in fields} == {f: ws[f] for f in fields}
    assert list(got.slot_tokens) == list(want.slot_tokens)


def test_paged_and_continuous_agree_and_paged_admits_more(jax_runs):
    """The paged-parity contract, on the port alone: token-identical to the
    monolithic engine, and more concurrent requests at equal KV budget."""
    _, params = jax_runs
    reports = {}
    for name, kw in ENGINES.items():
        eng, cfg = build_engine("granite-3-8b", prompt_len=PROMPT,
                                max_new_tokens=BUDGET, reduce_kw=REDUCE,
                                clock=SimClock(), params=params,
                                device="cpu", **kw)
        reports[name] = eng.run(_workload(synth_requests, cfg))
    assert _tokens(reports["paged"]) == _tokens(reports["continuous"])
    assert (reports["paged"].peak_concurrency
            > reports["continuous"].peak_concurrency)


def test_synth_requests_match_jax():
    cfg = reduced(get_arch("granite-3-8b"), **REDUCE)
    from repro.configs import get_arch as jax_get_arch
    from repro.configs import reduced as jax_reduced
    jcfg = jax_reduced(jax_get_arch("granite-3-8b"), **REDUCE)
    for kw in (dict(max_new_tokens=(2, 24)),
               dict(max_new_tokens=5, seed=3, rate_per_s=2.5)):
        ours = synth_requests(cfg, 6, 11, **kw)
        ref = jax_synth_requests(jcfg, 6, 11, **kw)
        for a, b in zip(ours, ref, strict=True):
            assert a.rid == b.rid and a.max_new_tokens == b.max_new_tokens
            assert a.arrival_s == b.arrival_s
            assert a.prompt.dtype == b.prompt.dtype
            assert a.prompt.tobytes() == b.prompt.tobytes()


def test_static_engine_matches_continuous_tokens(jax_runs):
    """Lockstep batches (equal prompt lengths) decode the same greedy
    tokens as the continuous engine."""
    jax_reports, params = jax_runs
    eng, cfg = build_engine("granite-3-8b", batch=SLOTS, prompt_len=PROMPT,
                            max_new_tokens=BUDGET, scheduler="static",
                            reduce_kw=REDUCE, clock=SimClock(),
                            params=params, device="cpu")
    got = _tokens(eng.run(synth_requests(cfg, 8, PROMPT,
                                         max_new_tokens=(2, BUDGET))))
    want = _tokens(jax_reports["continuous"])
    assert got == {rid: want[rid] for rid in got}


def test_paged_engine_refuses_unported_options():
    """The prefix cache and fault plans are ported: the paged engine takes
    both. What it still refuses is the disaggregated engine's worker
    layouts that the reference refuses too."""
    kw = dict(prompt_len=PROMPT, max_new_tokens=BUDGET, reduce_kw=REDUCE,
              device="cpu", scheduler="paged", batch=2)
    eng, _ = build_engine("granite-3-8b", **kw)
    from repro_torch.serving import DisaggregatedEngine, FaultPlan, PagedEngine
    args = (eng._prefill_fn, eng._decode_fn, eng.params, eng.cache_init)
    plan = FaultPlan.default(0)
    got = PagedEngine(*args, slots=2, cache_span=SPAN, device="cpu",
                      prefix_cache=True, fault_plan=plan)
    assert got.prefix_cache and got.fault_plan is plan
    for bad in (dict(decode_workers=0), dict(prefill_workers=0),
                dict(decode_workers=3)):
        with pytest.raises(ValueError, match="worker"):
            DisaggregatedEngine(*args, slots=2, cache_span=SPAN,
                                device="cpu", **bad)


def test_profile_run_summarises_a_run():
    """The profile summary of a CPU run: the schedule
    counts of a plain run, and no device activity."""
    from repro_torch.core.profile import _union_us, profile_run
    assert _union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    eng, cfg = build_engine("granite-3-8b", batch=2, prompt_len=PROMPT,
                            max_new_tokens=4, scheduler="paged",
                            prefill_chunk_tokens=4, reduce_kw=REDUCE,
                            device="cpu")
    reqs = synth_requests(cfg, 3, PROMPT, max_new_tokens=(2, 4))
    out = profile_run(eng, reqs)
    plain = eng.run(reqs).summary()
    assert out["decode_steps"] == plain["decode_steps"]
    assert out["prefills"] == plain["prefills"]
    assert out["kernel_launches"] == 0 and out["device_busy_share"] == 0.0
