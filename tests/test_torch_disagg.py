"""The port's P/D-disaggregated engine against the JAX package's.

Both packages' interleaved paged engine and ``DisaggregatedEngine`` under
``SimClock`` on reduced granite-3-8b (the reference's weights, bridged):

* the mixed burst of ``tools/ci_checks.py pd-parity`` (mixed budgets and
  prompt lengths, 4 lanes, 2 prefill and 2 decode workers);
* the staggered chunked-prefill-heavy stream of ``benchmarks/
  bench_serving.py``'s ``pd_disaggregation`` (2 lanes, 1 prefill and 2
  decode workers);
* the shared burst with the prefix cache on, through the disaggregated
  engine.

Held identical per rid: greedy tokens, role attribution, handoff
latencies and times; and the reports' handoffs, role utilisations,
handoff percentiles, queue depths and decode stalls. On the stream,
``results/findings.md`` §Disaggregation: decode-step p95 stall 40.0 s
interleaved, 0.0 s disaggregated, one handoff per request.
"""
import numpy as np
import pytest
import torch

import jax

from repro.data.pipeline import synth_requests as jax_synth_requests
from repro.launch.serve import build_engine as jax_build_engine
from repro.serving import Request as JaxRequest
from repro.serving import SimClock as JaxSimClock
from repro_torch.data.pipeline import synth_requests
from repro_torch.launch.serve import build_engine
from repro_torch.serving import (PageAllocator, PageHandoff,
                                 PoolInvariantError, Request, SimClock,
                                 prefill_owner)

torch.set_num_threads(2)
REDUCE = dict(layers=2, d_model=64, vocab=128, d_ff=128)
# workload -> (engine kwargs, disaggregated-only kwargs)
CELLS = {
    "mixed": (dict(batch=4, prompt_len=8, max_new_tokens=24, page_size=8,
                   prefill_chunk_tokens=4),
              dict(prefill_workers=2, decode_workers=2)),
    "stream": (dict(batch=2, prompt_len=16, max_new_tokens=12, page_size=4,
                    prefill_chunk_tokens=4),
               dict(prefill_workers=1, decode_workers=2)),
    "shared": (dict(batch=4, prompt_len=24, max_new_tokens=8, page_size=8,
                    num_pages=16, prefill_chunk_tokens=16,
                    prefix_cache=True),
               dict(prefill_workers=1, decode_workers=2)),
}


def _workload(name, req_cls, synth, cfg):
    if name == "mixed":
        reqs = synth(cfg, 8, 8, max_new_tokens=(2, 24))
        short = synth(cfg, 4, 5, max_new_tokens=5, seed=1)
        for r in short:
            r.rid += 100
        return reqs + short
    rng = np.random.default_rng(5 if name == "stream" else 7)
    if name == "stream":
        return [req_cls(rid=i, prompt=rng.integers(1, cfg.vocab_size, 16
                                                   ).astype(np.int32),
                        max_new_tokens=12, arrival_s=45.0 * i)
                for i in range(8)]
    system = rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
    return [req_cls(rid=i, prompt=np.concatenate(
        [system, rng.integers(1, cfg.vocab_size, 8).astype(np.int32)]),
        max_new_tokens=8) for i in range(8)]


def _kw(name, scheduler):
    kw, dis = CELLS[name]
    return dict(scheduler=scheduler, reduce_kw=REDUCE, **kw,
                **(dis if scheduler == "disaggregated" else {}))


SCHEDULERS = ("paged", "disaggregated")


@pytest.fixture(scope="module")
def jax_runs():
    out, params = {}, None
    for name in CELLS:
        for sched in SCHEDULERS:
            eng, cfg = jax_build_engine("granite-3-8b", clock=JaxSimClock(),
                                        **_kw(name, sched))
            out[name, sched] = eng.run(_workload(
                name, JaxRequest, jax_synth_requests, cfg))
            params = jax.tree.map(np.asarray, eng.params)
    return out, params


def _run(name, sched, params):
    eng, cfg = build_engine("granite-3-8b", clock=SimClock(), params=params,
                            device="cpu", **_kw(name, sched))
    return eng.run(_workload(name, Request, synth_requests, cfg))


def _tokens(report):
    return {m.rid: [int(t) for t in m.tokens] for m in report.metrics}


def _view(report):
    per_rid = {m.rid: (m.prefill_worker, m.decode_worker, m.slot,
                       m.handoff_latency_s, m.first_token_s, m.finish_s,
                       m.cached_prompt_tokens)
               for m in report.metrics}
    s = report.summary()
    keys = ("completed", "makespan_s", "decode_steps", "prefills",
            "peak_concurrency", "prefill_util", "decode_util", "handoffs",
            "handoff_p50_s", "handoff_p95_s", "queue_depth_peak",
            "queue_depth_mean", "decode_stall_p50_s", "decode_stall_p95_s",
            "prefill_tokens_saved", "prefix_hits")
    return (per_rid, {k: s.get(k) for k in keys},
            report.handoff_latencies_s, report.decode_stalls_s,
            list(report.slot_tokens))


@pytest.mark.parametrize("name", list(CELLS))
@pytest.mark.parametrize("sched", SCHEDULERS)
def test_engine_matches_jax(jax_runs, name, sched):
    want, params = jax_runs
    got = _run(name, sched, params)
    assert _tokens(got) == _tokens(want[name, sched])
    g, w = _view(got), _view(want[name, sched])
    assert g[0] == w[0] and g[2:] == w[2:]
    assert g[1].keys() == w[1].keys()
    for k in g[1]:
        assert g[1][k] == pytest.approx(w[1][k], abs=1e-9), k
    assert got.pages_leaked == 0


@pytest.mark.parametrize("name", list(CELLS))
def test_disaggregated_keeps_tokens_with_one_handoff_each(jax_runs, name):
    _, params = jax_runs
    inter, dis = (_run(name, s, params) for s in SCHEDULERS)
    assert _tokens(dis) == _tokens(inter)
    decoded = [m for m in dis.metrics if m.decode_worker >= 0]
    assert dis.handoffs == len(decoded) == len(dis.handoff_latencies_s)
    assert dis.handoffs == sum(1 for m in dis.metrics
                               if len(m.tokens) > 1)


def test_stall_reproduces_the_findings(jax_runs):
    _, params = jax_runs
    si, sd = (_run("stream", s, params).summary() for s in SCHEDULERS)
    assert (si["decode_stall_p95_s"], sd["decode_stall_p95_s"]) == (40.0,
                                                                    0.0)
    assert sd["handoffs"] == 8 and sd["completed"] == si["completed"] == 8
    assert (sd["prefill_util"], sd["decode_util"]) == pytest.approx(
        (0.8743, 0.1202), abs=1e-4)


def test_page_handoff_roles():
    alloc = PageAllocator(num_pages=8, page_size=4)
    released = []

    def release(a, owner):
        released.append(owner)
        a.free(owner)

    h = PageHandoff(alloc, release, 4)
    alloc.allocate(prefill_owner(1), 8)
    assert h.roles_of(1) == (True, False)
    pages = h.transfer(1)
    assert h.roles_of(1) == (False, True) and alloc.owned(1) == pages
    assert h.handoffs == 1 and released == [prefill_owner(1)]
    with pytest.raises(PoolInvariantError, match="double handoff"):
        alloc.allocate(prefill_owner(1), 4)
        h.transfer(1)
    h.abort(1)
    assert h.roles_of(1) == (False, True)
    with pytest.raises(PoolInvariantError, match="holds no pages"):
        h.abort(2)
    alloc.check()
