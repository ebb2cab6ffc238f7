"""The port's deadline reaping, priority preemption and requeue against
the JAX engines: the same reduced model (JAX's weights through the
bridge), the same small workloads under ``SimClock``, and identical
per-request tokens, outcomes, preemption/retry counts and times.

The pools and budgets are those of ``tests/test_faults.py``: the paged
pool fits one request, so a higher-priority arrival must evict.
"""
import numpy as np
import pytest
import torch

import jax

from repro.launch.serve import build_engine as jax_build_engine
from repro.serving import Request as JaxRequest
from repro.serving import SimClock as JaxSimClock
from repro_torch.launch.serve import build_engine
from repro_torch.serving import Request, SimClock

torch.set_num_threads(2)
REDUCE = dict(layers=2, d_model=64, vocab=128, d_ff=128)
PAGED = dict(scheduler="paged", page_size=4, num_pages=5)

# name -> (engine kwargs, [request kwargs], the summary count the case
# exists to exercise: it must be nonzero in the reference's run)
CASES = {
    "paged_preempts_lower_priority": (PAGED, [
        dict(rid=0), dict(rid=1, arrival_s=1.0, priority=5)],
        "requeues"),
    "paged_preemption_retries_bounded": (PAGED, [
        dict(rid=0, max_retries=0), dict(rid=1, arrival_s=1.0, priority=5)],
        "n_preempted"),
    "paged_deadline_frees_pages": (PAGED, [
        dict(rid=0, deadline_s=13.0), dict(rid=1)], "n_timed_out"),
    "paged_deadline_expires_in_queue": (PAGED, [
        dict(rid=0), dict(rid=1, arrival_s=1.0, deadline_s=3.0)],
        "n_timed_out"),
    "continuous_deadline_mid_decode": (dict(scheduler="continuous"), [
        dict(rid=0, deadline_s=12.0), dict(rid=1, deadline_s=100.0)],
        "n_timed_out"),
    "static_deadline_truncates": (dict(scheduler="static"), [
        dict(rid=0, deadline_s=12.0), dict(rid=1)], "n_timed_out"),
}


def _requests(cls, specs):
    return [cls(prompt=np.arange(1, 9, dtype=np.int32), max_new_tokens=8,
                **spec) for spec in specs]


def _view(report):
    out = {}
    for m in report.metrics:
        out[m.rid] = dict(
            outcome=m.outcome, finished=m.finished,
            tokens=[int(t) for t in (m.tokens if m.tokens is not None
                                     else [])],
            new_tokens=m.new_tokens, preemptions=m.preemptions,
            retries=m.retries, first_token_s=m.first_token_s,
            finish_s=m.finish_s)
    s = report.summary()
    keys = ("n_timed_out", "n_preempted", "preemption_events", "requeues",
            "retries", "decode_steps", "prefills", "makespan_s")
    return out, {k: s[k] for k in keys}


@pytest.mark.parametrize("case", list(CASES))
def test_slo_behaviour_matches_jax(case):
    kw, specs, exercised = CASES[case]
    common = dict(batch=2, prompt_len=8, max_new_tokens=8, reduce_kw=REDUCE)
    jeng, _ = jax_build_engine("granite-3-8b", clock=JaxSimClock(),
                               **common, **kw)
    want = jeng.run(_requests(JaxRequest, specs))
    assert want.summary()[exercised] > 0
    params = jax.tree.map(np.asarray, jeng.params)
    eng, _ = build_engine("granite-3-8b", clock=SimClock(), params=params,
                          device="cpu", **common, **kw)
    got = eng.run(_requests(Request, specs))
    assert _view(got) == _view(want)
    if kw["scheduler"] == "paged":
        assert got.pages_leaked == 0
