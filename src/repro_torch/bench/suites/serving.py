"""Tier-2 serving scenarios: request-level latency and deployment
behaviour through ``repro_torch.serving``, the port of
``benchmarks/bench_serving.py``.

The nine scenarios keep the reference's names, tags, workloads, shapes
and record fields:

* ``serving/goodput_vs_load``       — goodput, TTFT and per-token latency
  vs Poisson offered load (continuous scheduler);
* ``serving/static_vs_continuous``  — both schedulers on one burst with
  mixed decode budgets;
* ``serving/paged_vs_monolithic``   — the paged engine against the
  continuous one at equal KV memory (``SLOTS x span`` tokens);
* ``serving/paged_page_size``       — page size x offered load;
* ``serving/prefix_shared_burst``   — shared-system-prompt burst at equal
  KV budget, radix prefix cache off vs on;
* ``serving/multi_turn_replay``     — multi-turn session replay
  (``data/pipeline.synth_sessions``) off vs on;
* ``serving/chaos_soak``            — a deadline/priority burst
  fault-free vs under the default seeded ``FaultPlan``;
* ``serving/pd_disaggregation``     — a chunked-prefill-heavy staggered
  stream, interleaved paged engine vs P/D-disaggregated engine;
* ``serving/slot_balance``          — slot-occupancy load balance (Eq. 3
  over KV slots), uniform vs skewed budgets.

The workloads' knobs: ``device`` (``cuda`` unless the caller asks for
``cpu``, as ``--device cpu`` does) and ``reduced`` (the reference's
reduced cell, ``layers=2, d_model=64, vocab=128, d_ff=128``, for tests on
the CPU). Without ``reduced`` the model is granite-3-8b at full width and
depth (40 layers, d_model 4096, GQA 32:8, head dim 128, d_ff 12800, tied
vocab 49,155, f32): about 33 GB of parameters, built once per device and
shared by every engine of the suite (``build_engine(params=...)``), so
one card holds one copy; the engines' KV pools are tens of MB.

The prefix, chaos and P/D scenarios run under ``SimClock`` (as in the
reference), so their latency orderings are schedule-determined; the other
five run on the wall clock. Every record carries ``ttft_us`` (median
time-to-first-token) and per-token ``p50_us``/``p95_us`` from the
decode-step samples. ``REPORTS`` keeps each record's ``ServeReport`` from
the last run, for callers that hold the runs to more than the records
(``chip_smoke.py`` phase 9: token parity, handoffs, leaked pages).
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np

from repro_torch.bench import BenchRecord, Workload, scenario
from repro_torch.bench.runner import TimingStats


def _require(ok: bool, message: str) -> None:
    """A scenario's own gate: raises AssertionError, also under
    ``python -O``, so the runner records the workload as failed."""
    if not ok:
        raise AssertionError(message)


ARCH = "granite-3-8b"
PROMPT = 8
SLOTS = 4
MAX_BUDGET = 24
N_REQ = 8
SPAN = PROMPT + MAX_BUDGET
# the monolithic engines' KV budget in tokens: the paged engines below get
# a pool of exactly this many token slots (incl. the null page)
BUDGET_TOKENS = SLOTS * SPAN
PAGED_LANES = 8                    # decode lanes; admission is page-bound
REDUCE = dict(layers=2, d_model=64, vocab=128, d_ff=128)

_PAGE_KEYS = ("page_size", "num_pages", "page_occupancy_mean",
              "page_occupancy_peak", "fragmentation_mean",
              "fragmentation_peak", "pages_high_water", "failed_allocs",
              "admission_blocked_steps",
              # prefix-sharing radix cache (cache-enabled records only)
              "prefix_hit_rate", "prefix_hits", "prefix_lookups",
              "prefill_tokens_saved", "pages_shared_peak",
              "prefix_evictions", "ttft_warm_p50_s", "ttft_cold_p50_s")

# record name -> the ServeReport of its last run
REPORTS: Dict[str, object] = {}


def _cell(wl: Workload):
    """(device, reduced) of a workload: the key every engine cache uses."""
    return wl.knobs.get("device", "cuda"), bool(wl.knobs.get("reduced"))


@functools.lru_cache(maxsize=2)
def _params(device: str, use_reduced: bool):
    """The suite's one parameter set per cell: f32, from a seeded
    ``torch.Generator`` (seed 0, as every reference engine's init)."""
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import Runtime, build, resolve_device

    cfg = get_arch(ARCH)
    if use_reduced:
        cfg = reduced(cfg, **REDUCE)
    dev = resolve_device(device)
    model = build(cfg, Runtime(attention_backend="kernel"),
                  param_dtype=torch.float32, device=dev)
    return model.init_params(torch.Generator(device=dev).manual_seed(0))


def _build(device: str, use_reduced: bool, **kw):
    """``build_engine`` on the suite's shared parameters."""
    from repro_torch.launch.serve import build_engine

    return build_engine(ARCH, use_reduced=use_reduced, reduce_kw=REDUCE,
                        params=_params(device, use_reduced), device=device,
                        **kw)


@functools.lru_cache(maxsize=4)
def _engine(scheduler: str, device: str, use_reduced: bool):
    """One warmed engine per scheduler, built through the launcher's own
    ``build_engine``. Returns (engine, cfg)."""
    eng, cfg = _build(device, use_reduced, batch=SLOTS, prompt_len=PROMPT,
                      max_new_tokens=MAX_BUDGET, scheduler=scheduler)
    eng.warmup(PROMPT)
    return eng, cfg


@functools.lru_cache(maxsize=4)
def _paged_engine(page_size: int, device: str, use_reduced: bool):
    """Paged engine at the monolithic engines' exact KV memory budget:
    ``BUDGET_TOKENS // page_size`` pages total (one of which is the
    reserved null page). More decode lanes than the monolithic SLOTS:
    concurrency is bounded by free pages, which is the point."""
    eng, cfg = _build(device, use_reduced, batch=PAGED_LANES,
                      prompt_len=PROMPT, max_new_tokens=MAX_BUDGET,
                      scheduler="paged", page_size=page_size,
                      num_pages=BUDGET_TOKENS // page_size,
                      prefill_chunk_tokens=PROMPT // 2)
    eng.warmup(PROMPT)
    return eng, cfg


def _requests(wl: Workload, budgets, rate_per_s=0.0, n=N_REQ, seed=0):
    from repro_torch.data.pipeline import synth_requests

    cfg = _engine("continuous", *_cell(wl))[1]
    return synth_requests(cfg, n, PROMPT, max_new_tokens=budgets,
                          rate_per_s=rate_per_s, seed=seed)


def _record(name, report) -> BenchRecord:
    REPORTS[name] = report
    s = report.summary()
    tok_us = [t * 1e6 for t in report.token_latency_samples_s()]
    derived = {
        "scheduler": s["scheduler"],
        "goodput_rps": round(s["goodput_rps"], 3),
        "goodput_tps": round(s["goodput_tps"], 1),
        "completed": s["completed"],
        "decode_steps": s["decode_steps"],
        "prefills": s["prefills"],
        "occupancy": round(s["occupancy"], 4),
        "peak_concurrency": s["peak_concurrency"],
        "slot_balance": round(s["slot_balance"], 4),
        "makespan_s": round(s["makespan_s"], 5),
    }
    for key in _PAGE_KEYS:          # present on paged reports only
        if key in s:
            v = s[key]
            derived[key] = round(v, 4) if isinstance(v, float) else v
    return BenchRecord(
        name=name,
        us_per_call=TimingStats(tok_us) if tok_us else 0.0,
        ttft_us=s["ttft_p50_s"] * 1e6,
        derived=derived)


def _stamp(rec: BenchRecord, s: dict, keys) -> BenchRecord:
    """Copy the summary's ``keys`` (those present) onto the record."""
    for key in keys:
        if key in s:
            v = s[key]
            rec.derived[key] = round(v, 4) if isinstance(v, float) else v
    return rec


@scenario(
    "serving/goodput_vs_load", tags=("tier2", "serving", "measured"),
    paper_ref="Tier-2 deployment (goodput vs offered load)",
    workloads=[Workload(label=f"load{int(r)}", arch=ARCH,
                        knobs={"offered_rps": r})
               for r in (0.0, 16.0, 64.0)])
def goodput_vs_load(wl: Workload):
    """Continuous scheduler under Poisson offered load (0 = burst)."""
    rate = wl.knobs["offered_rps"]
    reqs = _requests(wl, budgets=(4, 12), rate_per_s=rate)
    report = _engine("continuous", *_cell(wl))[0].run(reqs)
    yield _record(f"serving/goodput_load{int(rate)}", report)


@scenario(
    "serving/static_vs_continuous", tags=("tier2", "serving", "measured"),
    paper_ref="Tier-2 deployment (scheduler comparison)",
    workloads=[Workload(label=sched, arch=ARCH, knobs={"scheduler": sched})
               for sched in ("static", "continuous")])
def static_vs_continuous(wl: Workload):
    """Both schedulers on one burst workload with mixed (2, 24) decode
    budgets: the static scheduler runs every batch to its longest member
    while the continuous scheduler backfills freed slots mid-stream."""
    sched = wl.knobs["scheduler"]
    reqs = _requests(wl, budgets=(2, MAX_BUDGET))
    report = _engine(sched, *_cell(wl))[0].run(reqs)
    yield _record(f"serving/sched_{sched}", report)


@scenario(
    "serving/paged_vs_monolithic",
    tags=("tier2", "serving", "paged", "measured"),
    paper_ref="Tier-2 deployment (KV memory management)",
    workloads=[Workload(label="continuous", arch=ARCH,
                        knobs={"scheduler": "continuous"}),
               Workload(label="paged", arch=ARCH,
                        knobs={"scheduler": "paged", "page_size": 8})])
def paged_vs_monolithic(wl: Workload):
    """Mixed-budget burst at equal KV memory budget (SLOTS x span
    tokens): the monolithic engine reserves a whole span per slot and
    caps concurrency at SLOTS; the paged engine reserves pages for actual
    request lengths and admits more requests at once
    (``peak_concurrency``)."""
    sched = wl.knobs["scheduler"]
    reqs = _requests(wl, budgets=(2, MAX_BUDGET))
    if sched == "paged":
        eng = _paged_engine(wl.knobs["page_size"], *_cell(wl))[0]
    else:
        eng = _engine(sched, *_cell(wl))[0]
    yield _record(f"serving/paged_vs_mono_{sched}", eng.run(reqs))


@scenario(
    "serving/paged_page_size",
    tags=("tier2", "serving", "paged", "measured"),
    paper_ref="Tier-2 deployment (page size x offered load)",
    workloads=[Workload(label=f"ps{ps}_load{int(r)}", arch=ARCH,
                        knobs={"page_size": ps, "offered_rps": r})
               for ps in (4, 16) for r in (0.0, 64.0)])
def paged_page_size(wl: Workload):
    """Page size x offered load over the paged engine at a fixed pool
    budget: small pages cut internal fragmentation but grow the block
    table; the records carry occupancy, fragmentation and goodput."""
    ps, rate = wl.knobs["page_size"], wl.knobs["offered_rps"]
    reqs = _requests(wl, budgets=(4, 12), rate_per_s=rate)
    report = _paged_engine(ps, *_cell(wl))[0].run(reqs)
    yield _record(f"serving/paged_ps{ps}_load{int(rate)}", report)


@functools.lru_cache(maxsize=4)
def _prefix_engine(prefix_cache: bool, span: int, num_pages: int,
                  device: str, use_reduced: bool, page_size: int = 8,
                  chunk: int = 16):
    """Paged engine pair for the prefix scenarios: identical pool budget
    and lanes, only the radix cache toggled. SimClock, so TTFT and
    admission orderings depend on the schedule alone."""
    from repro_torch.serving import SimClock

    return _build(device, use_reduced, batch=PAGED_LANES,
                  prompt_len=span - MAX_BUDGET, max_new_tokens=MAX_BUDGET,
                  scheduler="paged", page_size=page_size,
                  num_pages=num_pages, prefill_chunk_tokens=chunk,
                  prefix_cache=prefix_cache, clock=SimClock())


BURST_SPAN, BURST_PAGES = 24 + 8, 16   # 16 system + 8 suffix + 8 budget
REPLAY_TURNS, REPLAY_BUDGET, REPLAY_PAGES = 3, 8, 45
# longest final-turn prompt + budget
REPLAY_SPAN = 32 + REPLAY_TURNS * 16 + REPLAY_BUDGET


def _shared_burst(cfg, n=N_REQ, system_len=16, suffix_len=8, budget=8):
    """Burst of ``n`` requests sharing one system prompt with distinct
    user suffixes: the many-users-one-assistant admission pattern."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(7)
    system = rng.integers(1, cfg.vocab_size, system_len).astype(np.int32)
    reqs = []
    for i in range(n):
        suffix = rng.integers(1, cfg.vocab_size, suffix_len
                              ).astype(np.int32)
        reqs.append(Request(rid=i, prompt=np.concatenate([system, suffix]),
                            max_new_tokens=budget, arrival_s=0.0))
    return reqs


def _replay_sessions(cfg):
    """The multi-turn replay's sessions: 2 sessions x 3 turns, 200 s
    think time, 60 s stagger."""
    from repro_torch.data.pipeline import synth_sessions

    return synth_sessions(cfg, 2, REPLAY_TURNS, max_new_tokens=REPLAY_BUDGET,
                          think_s=200.0, stagger_s=60.0, seed=3)


@scenario(
    "serving/prefix_shared_burst",
    tags=("tier2", "serving", "paged", "prefix", "measured"),
    paper_ref="Tier-2 deployment (prefix sharing at equal KV budget)",
    workloads=[Workload(label="cache_off", arch=ARCH,
                        knobs={"prefix_cache": False}),
               Workload(label="cache_on", arch=ARCH,
                        knobs={"prefix_cache": True})])
def prefix_shared_burst(wl: Workload):
    """Shared-system-prompt burst at one fixed page budget: with the radix
    cache the prefix is one physical page set under N block tables, so
    the same pool admits more at once and skips the redundant prefill."""
    pc = wl.knobs["prefix_cache"]
    eng, cfg = _prefix_engine(pc, BURST_SPAN, BURST_PAGES, *_cell(wl))
    report = eng.run(_shared_burst(cfg))
    _require(report.completed == N_REQ,
             f"{report.completed}/{N_REQ} completed")
    if pc:
        _require(report.prefill_tokens_saved > 0,
                 "cache on but nothing saved")
    yield _record(f"serving/prefix_burst_{'on' if pc else 'off'}", report)


@scenario(
    "serving/multi_turn_replay",
    tags=("tier2", "serving", "paged", "prefix", "measured"),
    paper_ref="Tier-2 deployment (multi-turn session replay)",
    workloads=[Workload(label="cache_off", arch=ARCH,
                        knobs={"prefix_cache": False}),
               Workload(label="cache_on", arch=ARCH,
                        knobs={"prefix_cache": True})])
def multi_turn_replay(wl: Workload):
    """Chat sessions replaying their accumulated history every turn: with
    the cache on, turn t matches turn t-1's prompt pages and re-prefills
    only the newest turn, so warm-turn TTFT must beat cold-turn TTFT."""
    pc = wl.knobs["prefix_cache"]
    eng, cfg = _prefix_engine(pc, REPLAY_SPAN, REPLAY_PAGES, *_cell(wl))
    reqs = _replay_sessions(cfg)
    report = eng.run(reqs)
    _require(report.completed == len(reqs),
             f"{report.completed}/{len(reqs)} completed")
    if pc:
        warm, cold = (report.ttft_warm_samples_s(),
                      report.ttft_cold_samples_s())
        _require(bool(warm and cold), "replay produced no warm/cold split")
        _require(max(warm) < min(cold),
                 f"warm TTFT {warm} not strictly below cold TTFT {cold}")
        _require(report.prefix_hit_rate > 0, "no prefix hits")
    yield _record(f"serving/replay_{'on' if pc else 'off'}", report)


# robustness counters stamped onto chaos_soak records only (the other
# scenarios keep the reference's derived-key sets)
_ROBUST_KEYS = ("n_timed_out", "n_preempted", "n_rejected", "n_failed",
                "preemption_events", "requeues", "retries",
                "faults_injected", "fault_recoveries",
                "recovery_steps_mean", "recovery_steps_max", "pages_leaked")


@functools.lru_cache(maxsize=2)
def _chaos_engine(device: str, use_reduced: bool):
    """Paged engine under SimClock for the chaos soak: a deliberately
    tight pool (12 usable pages, about 3 concurrent requests across 2
    lanes) so injected pressure, refusals and priority preemption bite."""
    from repro_torch.serving import SimClock

    return _build(device, use_reduced, batch=2, prompt_len=18,
                  max_new_tokens=6, scheduler="paged", page_size=4,
                  num_pages=13, prefill_chunk_tokens=4, clock=SimClock())


def _slo_burst(cfg, n=8):
    """Staggered burst with deadlines and a half/half priority mix: the
    workload every robustness knob (reaper, preemption, requeue, fault
    containment) acts on."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(13)
    return [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size, 6 + 2 * (i % 3)
                                        ).astype(np.int32),
                    max_new_tokens=5 + (i % 2), arrival_s=0.5 * i,
                    deadline_s=600.0, priority=2 * (i % 2))
            for i in range(n)]


@scenario(
    "serving/chaos_soak",
    tags=("tier2", "serving", "paged", "faults", "measured"),
    paper_ref="Tier-2 deployment (goodput under injected faults)",
    workloads=[Workload(label="baseline", arch=ARCH,
                        knobs={"faults": False}),
               Workload(label="chaos", arch=ARCH, knobs={"faults": True})])
def chaos_soak(wl: Workload):
    """The same deadline/priority burst fault-free vs under the default
    seeded FaultPlan (alloc refusals, pool pressure, a slow step, a
    prefill error, pool poisoning). Both runs must drain the pool clean:
    a leaked page here is an engine bug, not chaos."""
    from repro_torch.serving import FaultPlan

    faulted = wl.knobs["faults"]
    eng, cfg = _chaos_engine(*_cell(wl))
    eng.fault_plan = FaultPlan.default(seed=0) if faulted else None
    try:
        report = eng.run(_slo_burst(cfg))
    finally:
        eng.fault_plan = None
    _require(report.pages_leaked == 0,
             f"{report.pages_leaked} pages leaked (faults={faulted})")
    s = report.summary()
    if faulted:
        _require(s["faults_injected"] > 0, "fault plan injected nothing")
        _require(s["fault_recoveries"] == s["faults_injected"],
                 f"unrecovered: {s['fault_recoveries']}/"
                 f"{s['faults_injected']}")
    rec = _record(f"serving/chaos_{'on' if faulted else 'off'}", report)
    yield _stamp(rec, s, _ROBUST_KEYS)  # faults_* absent on the baseline


# role/handoff/stall keys stamped onto pd_disaggregation records only
_PD_KEYS = ("prefill_workers", "decode_workers", "prefill_util",
            "decode_util", "handoffs", "handoff_p50_s", "handoff_p95_s",
            "queue_depth_peak", "queue_depth_mean",
            "decode_stall_p50_s", "decode_stall_p95_s")


@functools.lru_cache(maxsize=2)
def _pd_engine(scheduler: str, device: str, use_reduced: bool):
    """Interleaved/disaggregated engine pair for the P/D scenario: the
    same model, page pool, lane count (2 lanes on both sides) and chunked
    prefill; only the loop composition differs. SimClock, so the stall
    distribution is schedule-determined."""
    from repro_torch.serving import SimClock

    kw = (dict(prefill_workers=1, decode_workers=2)
          if scheduler == "disaggregated" else {})
    return _build(device, use_reduced, batch=2, prompt_len=16,
                  max_new_tokens=12, scheduler=scheduler, page_size=4,
                  prefill_chunk_tokens=4, clock=SimClock(), **kw)


def _pd_stream(cfg, n=8, prompt_len=16, budget=12, stagger_s=45.0):
    """Chunked-prefill-heavy staggered stream: each arrival lands while
    earlier requests are mid-decode, so the interleaved loop must stall
    its live decode lanes for every multi-chunk prefill dispatch."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(5)
    return [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size, prompt_len
                                        ).astype(np.int32),
                    max_new_tokens=budget, arrival_s=stagger_s * i)
            for i in range(n)]


@scenario(
    "serving/pd_disaggregation",
    tags=("tier2", "serving", "paged", "disagg", "measured"),
    paper_ref="Tier-2 deployment (P/D disaggregation)",
    workloads=[Workload(label="interleaved", arch=ARCH,
                        knobs={"scheduler": "paged"}),
               Workload(label="disaggregated", arch=ARCH,
                        knobs={"scheduler": "disaggregated"})])
def pd_disaggregation(wl: Workload):
    """The same staggered stream through both loop compositions: the
    interleaved engine prefills and decodes on one timeline, the
    disaggregated engine runs separate prefill/decode worker pools over
    one shared page pool and hands pages off between roles."""
    sched = wl.knobs["scheduler"]
    eng, cfg = _pd_engine(sched, *_cell(wl))
    report = eng.run(_pd_stream(cfg))
    _require(report.completed == len(report.metrics),
             f"{sched}: {report.completed}/{len(report.metrics)} completed")
    rec = _record(f"serving/pd_{wl.label}", report)
    yield _stamp(rec, report.summary(), _PD_KEYS)


@scenario(
    "serving/slot_balance", tags=("tier2", "serving", "measured"),
    paper_ref="Eq. 3 (load balance over KV slots)",
    workloads=[Workload(label="uniform", arch=ARCH,
                        knobs={"budgets": (8, 8)}),
               Workload(label="skewed", arch=ARCH,
                        knobs={"budgets": (2, 2, 2, MAX_BUDGET)})])
def slot_balance(wl: Workload):
    """Slot-occupancy load balance under uniform vs skewed budget mixes
    (continuous scheduler, burst arrivals)."""
    reqs = _requests(wl, budgets=wl.knobs["budgets"])
    report = _engine("continuous", *_cell(wl))[0].run(reqs)
    yield _record(f"serving/slots_{wl.label}", report)
