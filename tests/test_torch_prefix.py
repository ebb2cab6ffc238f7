"""The port's prefix-sharing radix cache against the JAX package's.

* ``RadixCache`` and its ``PageAllocator`` against the reference's over
  seeded sequences of lookups, admissions (attach + insert), retirements
  and evictions: the same page ids, match lengths, evictions and
  refcounts at every step.
* The prefix-cached paged engine against the reference's under
  ``SimClock`` on reduced granite-3-8b (the JAX engine's weights through
  the bridge): the shared-system-prompt burst and the multi-turn replay
  of ``benchmarks/bench_serving.py``, and the burst with rid 0's prompt
  sent again (the whole prompt cached: the copy-on-write path). Greedy
  tokens per rid, the prefix counters and the warm/cold TTFTs are held
  exactly, as are the numbers of ``results/findings.md`` §Prefix sharing.
* The port writes its pools in place, so a shared page's bytes are held
  unchanged while other sharers prefill and decode (``chip_smoke.py``'s
  ``SharedPageWatch``, which phase 9 runs on the card), and the watch is
  shown to catch a write into a shared page.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.launch.serve import build_engine as jax_build_engine
from repro.serving import PageAllocator as JaxPageAllocator
from repro.serving import RadixCache as JaxRadixCache
from repro.serving import Request as JaxRequest
from repro.serving import SimClock as JaxSimClock
from repro.data.pipeline import synth_sessions as jax_synth_sessions
from repro_torch.data.pipeline import synth_sessions
from repro_torch.launch.serve import build_engine
from repro_torch.serving import PageAllocator, RadixCache, Request, SimClock

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
REDUCE = dict(layers=2, d_model=64, vocab=128, d_ff=128)
BUDGET, LANES, PS, CHUNK = 8, 8, 8, 16
# workload -> (span, pool pages), as benchmarks/bench_serving.py sizes them
CELLS = {"burst": (24 + 8, 16), "cow": (24 + 8, 16),
         "replay": (32 + 3 * 16 + BUDGET, 45)}


# ------------------------------------------------------------ radix cache
def _ops(seed, page_size, n_ops=120):
    """A seeded sequence of cache operations over prompts that share
    prefixes (a few bases, cut at random lengths, random suffixes)."""
    rng = np.random.default_rng(seed)
    bases = [rng.integers(1, 6, 40) for _ in range(3)]
    for _ in range(n_ops):
        kind = rng.choice(["admit", "admit", "retire", "evict", "lookup"])
        base = bases[rng.integers(len(bases))]
        cut = int(rng.integers(0, 5 * page_size))
        seq = np.concatenate([base[:cut], rng.integers(1, 6, int(
            rng.integers(1, 2 * page_size)))]).astype(np.int32)
        yield kind, seq, int(rng.integers(0, 1 << 30)), int(
            rng.integers(1, 4))


def _state(alloc, radix):
    return ([alloc.refcount(p) for p in range(1, alloc.num_pages)],
            alloc.num_free, alloc.num_owners, radix.num_pages,
            radix.evictions)


@pytest.mark.parametrize("seed,page_size", [(0, 4), (1, 8), (2, 2)])
def test_radix_cache_matches_jax(seed, page_size):
    sides = {}
    for name, (A, R) in (("jax", (JaxPageAllocator, JaxRadixCache)),
                         ("torch", (PageAllocator, RadixCache))):
        alloc = A(num_pages=24, page_size=page_size)
        sides[name] = (alloc, R(alloc))
    live = []
    owner = 0
    for kind, seq, pick, n_evict in _ops(seed, page_size):
        got, admitted = {}, False
        for name, (alloc, radix) in sides.items():
            if kind == "lookup":
                got[name] = radix.lookup(seq)
            elif kind == "evict":
                got[name] = radix.evict(n_evict)
            elif kind == "retire":
                got[name] = (alloc.free(live[pick % len(live)])
                             if live else None)
            else:                                   # attach, then insert
                pages, matched = radix.lookup(seq)
                k = min(matched, len(seq) - 1) // page_size
                need = -(-len(seq) // page_size) - k
                freed = (radix.evict(need - alloc.num_free,
                                     protect=frozenset(pages))
                         if need > alloc.num_free else 0)
                if need > alloc.num_free:
                    got[name] = (pages, matched, freed)
                else:
                    mine = alloc.allocate(owner, len(seq), shared=pages[:k])
                    got[name] = (pages, matched, freed, mine,
                                 radix.insert(seq, mine))
                    admitted = True
            got[name] = (got[name], _state(alloc, radix))
        assert got["torch"] == got["jax"], (kind, seq)
        if kind == "retire" and live:
            live.pop(pick % len(live))
        if admitted:
            live.append(owner)
            owner += 1
    for alloc, _ in sides.values():
        alloc.check()


# ------------------------------------------------------- engines vs JAX
def _burst(req_cls, vocab, cow=False):
    """benchmarks/bench_serving.py's shared burst (16-token system prompt,
    8-token suffixes, budget 8); with ``cow``, rid 8 sends rid 0's prompt
    again at t=1."""
    rng = np.random.default_rng(7)
    system = rng.integers(1, vocab, 16).astype(np.int32)
    reqs = [req_cls(rid=i, prompt=np.concatenate(
                [system, rng.integers(1, vocab, 8).astype(np.int32)]),
                    max_new_tokens=BUDGET, arrival_s=0.0)
            for i in range(8)]
    if cow:
        reqs.append(req_cls(rid=8, prompt=reqs[0].prompt.copy(),
                            max_new_tokens=BUDGET, arrival_s=1.0))
    return reqs


def _workload(name, req_cls, synth, cfg):
    if name == "replay":
        return synth(cfg, 2, 3, max_new_tokens=BUDGET, think_s=200.0,
                     stagger_s=60.0, seed=3)
    return _burst(req_cls, cfg.vocab_size, cow=name == "cow")


def _kw(name, pc):
    span, pages = CELLS[name]
    return dict(batch=LANES, prompt_len=span - 24, max_new_tokens=24,
                scheduler="paged", page_size=PS, num_pages=pages,
                prefill_chunk_tokens=CHUNK, prefix_cache=pc,
                reduce_kw=REDUCE)


@pytest.fixture(scope="module")
def jax_runs():
    """The reference's reports per (workload, cache) and its weights."""
    out, params = {}, None
    for name in CELLS:
        for pc in (False, True):
            eng, cfg = jax_build_engine("granite-3-8b", clock=JaxSimClock(),
                                        **_kw(name, pc))
            out[name, pc] = eng.run(_workload(name, JaxRequest,
                                              jax_synth_sessions, cfg))
            params = jax.tree.map(np.asarray, eng.params)
    return out, params


def _port_engine(name, pc, params):
    return build_engine("granite-3-8b", clock=SimClock(), params=params,
                        device="cpu", **_kw(name, pc))


def _tokens(report):
    return {m.rid: [int(t) for t in m.tokens] for m in report.metrics}


PREFIX_FIELDS = ("prefix_hits", "prefix_lookups", "prefill_tokens_saved",
                 "pages_shared_peak", "prefix_evictions", "prefix_hit_rate",
                 "ttft_warm_p50_s", "ttft_cold_p50_s")
SCHEDULE_FIELDS = ("completed", "makespan_s", "decode_steps", "prefills",
                   "peak_concurrency", "admission_blocked_steps",
                   "pages_high_water", "page_occupancy_mean",
                   "fragmentation_mean", "ttft_p50_s", "tok_p50_s")


@pytest.mark.parametrize("name", list(CELLS))
@pytest.mark.parametrize("pc", [False, True], ids=["cache_off", "cache_on"])
def test_prefix_engine_matches_jax(jax_runs, name, pc):
    want_reports, params = jax_runs
    eng, cfg = _port_engine(name, pc, params)
    got = eng.run(_workload(name, Request, synth_sessions, cfg))
    want = want_reports[name, pc]
    assert _tokens(got) == _tokens(want)
    assert ({m.rid: m.cached_prompt_tokens for m in got.metrics}
            == {m.rid: m.cached_prompt_tokens for m in want.metrics})
    gs, ws = got.summary(), want.summary()
    fields = SCHEDULE_FIELDS + (PREFIX_FIELDS if pc else ())
    for f in fields:
        assert gs[f] == pytest.approx(ws[f], abs=1e-9), f
    assert got.pages_leaked == 0


def test_prefix_cache_keeps_tokens_and_reproduces_the_findings(jax_runs):
    """Cache on vs off on the port alone: identical greedy tokens, and
    ``results/findings.md`` §Prefix sharing's numbers."""
    _, params = jax_runs
    rep = {}
    for name in CELLS:
        for pc in (False, True):
            eng, cfg = _port_engine(name, pc, params)
            rep[name, pc] = eng.run(_workload(name, Request, synth_sessions,
                                              cfg))
        assert _tokens(rep[name, True]) == _tokens(rep[name, False])
    off, on = rep["burst", False], rep["burst", True]
    assert (on.peak_concurrency, off.peak_concurrency) == (6, 3)
    assert (on.prefills, off.prefills) == (9, 16)
    assert on.prefill_tokens_saved == 112 and on.pages_shared_peak == 10
    replay = rep["replay", True].summary()
    assert replay["prefill_tokens_saved"] == 256
    assert (replay["ttft_warm_p50_s"], replay["ttft_cold_p50_s"]) == (
        10.0, 30.0)
    cow = {m.rid: m.cached_prompt_tokens for m in rep["cow", True].metrics}
    assert cow[8] == 23                      # the whole prompt, less one


# ----------------------------------------------------- shared pages
@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["cow", "replay"])
def test_shared_pages_stay_unchanged(jax_runs, smoke, name):
    _, params = jax_runs
    eng, cfg = _port_engine(name, True, params)
    watch = smoke.SharedPageWatch()
    watch.attach(eng)
    rep = eng.run(_workload(name, Request, synth_sessions, cfg))
    assert rep.completed == len(rep.metrics)
    assert watch.watched > 0 and watch.checks > watch.watched
    assert watch.violations == []


def test_shared_page_watch_catches_a_write_into_a_shared_page(jax_runs,
                                                              smoke):
    _, params = jax_runs
    eng, cfg = _port_engine("burst", True, params)
    prefill = eng._chunked_prefill

    def corrupting(prompt, btab_dev, clock, *, start=0):
        out = prefill(prompt, btab_dev, clock, start=start)
        if start:                    # a warm prefill: write its shared page
            eng._caches["layers"]["v"][:, int(btab_dev[0, 0])] += 1.0
        return out

    eng._chunked_prefill = corrupting
    watch = smoke.SharedPageWatch()
    watch.attach(eng)
    eng.run(_workload("burst", Request, synth_sessions, cfg))
    assert watch.violations
