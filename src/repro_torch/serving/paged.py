"""Paged-KV continuous batching: block-table scheduling over a page pool.

The PyTorch counterpart of ``repro/serving/paged.py``. :class:`PagedEngine`
keeps the continuous scheduler's decode lanes but replaces the per-slot
``cache_span`` KV reservation with a global pool of fixed-size pages
(:mod:`repro_torch.serving.pages`):

* **admission** is gated on enough free pages for ``prompt_len +
  max_new_tokens`` tokens, so at equal KV memory the paged engine admits
  more concurrent requests whenever requests are shorter than the span;
* **prefill is chunked**: the prompt streams through
  ``prefill_chunk_tokens``-sized chunks, each writing its K/V straight
  into the request's pages;
* **decode** runs the continuous engine's pool step through the
  block-table path (``model.decode_step_paged`` -> kernel K2 on the card,
  its plain version on the CPU); retirement returns pages to the
  allocator mid-stream and points the lane's table at the null page.

Deadlines and priority preemption (evict, requeue with the generated
tokens appended to the prompt) behave as in the reference.

With ``prefix_cache=True`` a :class:`~repro_torch.serving.prefix.RadixCache`
sits between the queue and the allocator: admission looks up the longest
cached page-aligned prefix of the prompt, attaches the matched pages
read-only into the block table (one physical page, N logical owners via
the allocator's refcounts), and chunk-prefills only the uncached suffix.
When the *entire* prompt is cached, the last matched page is
copy-on-written (duplicated into a fresh page, an in-place ``copy_`` on
both pools) so re-prefilling the one token needed for first-token logits
never writes a shared page. Sequences are indexed on prefill completion
(the prompt) and again on retirement (the generated tokens: what makes a
returning multi-turn session warm); LRU refcount-1 entries are evicted
when the pool runs low. Disabled (the default), the engine's schedule is
the cache-free one.

With a ``fault_plan`` (:mod:`repro_torch.serving.faults`) the loop
consults a :class:`~repro_torch.serving.faults.FaultInjector` at every
engine step and audits the pool after every event: a fault either
recovers or fails the one request it hit, and surviving requests' greedy
tokens equal a fault-free run's.

Greedy outputs are token-identical to the monolithic engines: paging and
prefix reuse are memory-layout changes, not numerics changes. The pools
are written in place (the reference's are functional), so a shared page
must never be a write target: chunked prefill writes only positions at
or past the suffix start, decode only past the prompt.

The engine takes the model's *paged* triple:
``prefill_fn(params, caches, tokens, block_tables, start_pos)`` (``start_pos``
may land mid-page, the warm-suffix path),
``decode_fn(params, caches, token, pos, block_tables)`` and
``cache_init(num_pages, page_size)``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serving.engine import (SCHEDULERS, _admit_lane,
                                        _advance_lanes, _EngineBase,
                                        _generator, _sample_tokens)
from repro_torch.serving.faults import FaultInjector, FaultPlan, InjectedFault
from repro_torch.serving.pages import (PageAllocator, PoolInvariantError,
                                       PoolStats, pages_needed)
from repro_torch.serving.prefix import RadixCache
from repro_torch.serving.request import Request, ServeReport
from repro_torch.serving.roles import (DecodeWorker, PageHandoff,
                                       PrefillWorker, Scheduler, host, sync)


@dataclass
class _RunState:
    """Per-``run`` bookkeeping that the paged and disaggregated loops share
    with the fault-containment and requeue helpers below. ``plen_of``
    tracks the *current* incarnation of each request (a requeue replaces
    it with the extended-prompt version); ``partial`` holds the tokens a
    preempted/faulted request generated before eviction, so its terminal
    metrics report the cumulative stream."""
    sched: Scheduler
    alloc: PageAllocator
    radix: Optional[RadixCache]
    inj: Optional[FaultInjector]
    metrics: dict
    plen_of: Dict[int, int]
    prompt_of: Dict[int, np.ndarray] = field(default_factory=dict)
    partial: Dict[int, np.ndarray] = field(default_factory=dict)
    requeues: int = 0


class PagedEngine(_EngineBase):
    """Continuous batching over ``slots`` decode lanes and a paged KV
    pool of ``num_pages`` pages of ``page_size`` tokens (page 0 is the
    reserved null page). ``num_pages=None`` sizes the pool to the
    monolithic engine's budget (``slots x cache_span`` tokens) plus the
    null page. ``prefill_chunk_tokens=0`` prefills each prompt in one
    chunk. ``prefix_cache=True`` enables the prefix-sharing radix cache;
    ``fault_plan`` runs every ``run`` under deterministic fault
    injection."""

    scheduler = "paged"

    def __init__(self, prefill_fn, decode_fn, params, cache_init, *,
                 slots: int, cache_span: int, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefill_chunk_tokens: int = 0,
                 prefix_cache: bool = False,
                 fault_plan: Optional[FaultPlan] = None, **kw):
        self.page_size = int(page_size)
        self.fault_plan = fault_plan
        # block-table width: logical pages a maximal request can touch
        self.npag_max = -(-cache_span // self.page_size)
        if num_pages is None:
            num_pages = slots * self.npag_max + 1
        self.num_pages = int(num_pages)
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.prefix_cache = bool(prefix_cache)
        self._caches = None
        super().__init__(prefill_fn, decode_fn, params, cache_init,
                         slots=slots, cache_span=cache_span, **kw)

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1            # minus the null page

    # --------------------------------------------------------- validation
    def admission_error(self, r: Request) -> Optional[str]:
        err = super().admission_error(r)     # budget >= 1, block-table fit
        if err:
            return err
        need = pages_needed(r.prompt_len + r.max_new_tokens, self.page_size)
        if need > self.usable_pages:
            return (f"needs {need} KV pages ({r.prompt_len}+"
                    f"{r.max_new_tokens} tokens at page_size "
                    f"{self.page_size}) but the pool has only "
                    f"{self.usable_pages} usable pages")
        return None

    # ------------------------------------------------------- device steps
    def _pool_step(self, params, caches, state, gen):
        logits, caches = self._decode_fn(params, caches, state["tok"],
                                         state["pos"], state["btab"])
        tok = _sample_tokens(logits[:, -1], gen, self.greedy)      # (B,)
        still = _advance_lanes(state, tok, self.eos_id)
        # retired rows point at the null page so a stale table can never
        # write into a page the allocator reissued
        state["btab"] = torch.where(still[:, None], state["btab"], 0)
        return caches

    def _admit(self, state, tok0, btab_row, slot, plen, budget, active0):
        # no cache insertion: chunked prefill already wrote this request's
        # K/V into its own pages of the shared pool
        _admit_lane(state, tok0, slot, plen, budget, active0)
        state["btab"][slot] = btab_row

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate page ``src`` into page ``dst`` in every
        pool (axis 0 = layers, axis 1 = pages), in place."""
        for pool in self._caches["layers"].values():
            pool[:, dst].copy_(pool[:, src])

    def warmup(self, prompt_len: int) -> None:
        # warming up must not consume the fault schedule (every run()
        # builds a fresh injector, but warming up under chaos would
        # fail/requeue dummy requests for nothing)
        plan, self.fault_plan = self.fault_plan, None
        try:
            super().warmup(prompt_len)
        finally:
            self.fault_plan = plan

    # ----------------------------------------------------------- teardown
    def _release_pages(self, alloc: PageAllocator, rid) -> None:
        """Return a request's pages to the pool. Every terminal path
        (completion, deadline reap, preemption, fault failure) releases
        through this one seam; ``tests/test_torch_faults.py`` self-tests
        the leak detection by no-op'ing it and requiring leaked pages."""
        alloc.free(rid)

    # ---------------------------------------------------------- prefill
    def _chunked_prefill(self, prompt: np.ndarray, btab_dev, clock, *,
                         start: int = 0):
        """Stream prompt positions ``[start, len)`` through the pool in
        chunks; returns the last chunk's logits and the number of chunks
        run. ``start > 0`` is the warm path: positions below it are
        already resident in attached prefix pages, so only the suffix
        pays prefill compute. Each chunk sees only the first
        ``pages_needed(written)`` pages of the block table, so attention
        cost grows with the live prefix rather than the full span."""
        plen = int(prompt.shape[0])
        cs = self.prefill_chunk_tokens or (plen - start)
        logits = None
        chunks = 0
        for lo in range(start, plen, cs):
            end = min(lo + cs, plen)
            n_live = pages_needed(end, self.page_size)
            chunk = torch.as_tensor(prompt[None, lo:end], device=self.device)
            logits, self._caches = self._prefill_fn(
                self.params, self._caches, chunk, btab_dev[:, :n_live], lo)
            sync(self.device)
            clock.charge("prefill")     # each chunk is a prefill dispatch
            chunks += 1
        return logits, chunks

    # --------------------------------------------------------- admission
    def _reserve_pages(self, req: Request, alloc: PageAllocator,
                       radix: Optional[RadixCache], owner=None):
        """Try to reserve pages for ``req``, reusing the longest cached
        prefix when the radix cache is on. Returns ``(pages,
        suffix_start)`` or ``None`` when the pool (even after LRU
        eviction) cannot cover the fresh remainder; the caller blocks the
        queue head until a retirement frees pages. ``owner`` is the
        allocator key the reservation is held under (default: the rid).

        The suffix start is capped at ``prompt_len - 1``: at least one
        prompt token must be re-prefilled to produce the first-token
        logits. When the whole prompt is cached that cap lands mid-page,
        so the final matched page is attached *copy-on-write* (its K/V
        duplicated into a fresh page before the one-token prefill writes
        into it) and every fully matched page stays read-only."""
        owner = req.rid if owner is None else owner
        total_tokens = req.prompt_len + req.max_new_tokens
        if radix is None:
            if not alloc.can_fit(total_tokens):
                return None
            return alloc.allocate(owner, total_tokens), 0
        match_pages, match_tok = radix.lookup(np.asarray(req.prompt))
        s0 = min(match_tok, req.prompt_len - 1)
        k_full = s0 // self.page_size
        shared = match_pages[:k_full]
        cow_src = match_pages[k_full] if s0 < match_tok else None
        need_fresh = pages_needed(total_tokens, self.page_size) - len(shared)
        if need_fresh > alloc.num_free:
            radix.evict(need_fresh - alloc.num_free,
                        protect=frozenset(match_pages))
        if need_fresh > alloc.num_free:
            return None
        pages = alloc.allocate(owner, total_tokens, shared=shared)
        if cow_src is not None:
            self._copy_page(cow_src, pages[k_full])
        return pages, s0

    # ------------------------------------------- shared by both run loops
    def _new_run_state(self, sched: Scheduler, reqs, rejected) -> _RunState:
        alloc = PageAllocator(self.num_pages, self.page_size)
        return _RunState(
            sched=sched, alloc=alloc,
            radix=RadixCache(alloc) if self.prefix_cache else None,
            inj=FaultInjector(self.fault_plan) if self.fault_plan else None,
            metrics=self._make_metrics(reqs, rejected),
            plen_of={r.rid: r.prompt_len for r in reqs})

    @staticmethod
    def _audit(rs: _RunState) -> None:
        """Under a fault plan the pool is re-checked at every event; a
        poison fault is *supposed* to trip this: the injector heals it
        and the pool must check clean again. A failure the injector
        cannot heal is real corruption and escapes."""
        if rs.inj is None:
            return
        try:
            rs.alloc.check()
        except PoolInvariantError:
            if not rs.inj.heal(rs.alloc):
                raise
            rs.alloc.check()

    @staticmethod
    def _index_sequence(rs: _RunState, rid: int, gen_toks: np.ndarray) -> None:
        """Index the retiring request's full pages: its prompt plus every
        generated token whose K/V was written (the final sampled token
        never reaches the pool: no decode step consumed it)."""
        seq = np.concatenate([rs.prompt_of[rid],
                              np.asarray(gen_toks[:-1], np.int32)])
        rs.radix.insert(seq, rs.alloc.owned(rid))

    @staticmethod
    def _cumulative(rs: _RunState, rid: int, gen_toks) -> np.ndarray:
        prev = rs.partial.get(rid)
        gen_toks = np.asarray(gen_toks, np.int32)
        return gen_toks if prev is None else np.concatenate([prev, gen_toks])

    def _reap_queued(self, rs: _RunState, now_rel: float) -> None:
        """Time out queued requests past their deadline; one that was
        evicted earlier keeps the tokens it made before eviction."""
        for r in rs.sched.reap_queued(now_rel):
            m = rs.metrics[r.rid]
            m.outcome = "timed_out"
            cum = self._cumulative(rs, r.rid, np.zeros(0, np.int32))
            if len(cum):
                m.new_tokens = len(cum)
                m.tokens = cum
                m.finish_s = now_rel

    def _requeue_or_fail(self, rs: _RunState, rid: int, gen_toks: np.ndarray,
                         now_rel: float, exhausted_outcome: str) -> None:
        """Put an evicted request back in the queue with its generated-so-
        far tokens appended to its prompt (greedy re-prefill of the
        extended prompt reproduces the continuation exactly, and
        warm-restarts through the radix cache when it is on). After
        ``max_retries`` requeues it goes terminal."""
        r = rs.sched.req_of[rid]
        m = rs.metrics[rid]
        cum = self._cumulative(rs, rid, gen_toks)
        m.retries += 1
        if m.retries > r.max_retries:
            m.outcome = exhausted_outcome
            m.finish_s = now_rel
            m.new_tokens = len(cum)
            m.tokens = cum
            return
        if len(gen_toks):
            rs.partial[rid] = cum
        nr = Request(
            rid=rid,
            prompt=np.concatenate([np.asarray(r.prompt, np.int32),
                                   np.asarray(gen_toks, np.int32)]),
            max_new_tokens=r.max_new_tokens - len(gen_toks),
            arrival_s=now_rel,
            # the absolute deadline survives the requeue
            deadline_s=(None if r.deadline_abs_s is None
                        else r.deadline_abs_s - now_rel),
            priority=r.priority, max_retries=r.max_retries)
        rs.plen_of[rid] = nr.prompt_len
        rs.sched.requeue(nr)
        rs.requeues += 1

    # -------------------------------------------------------------- run
    def run(self, requests: Sequence[Request]) -> ServeReport:
        # role composition (interleaved): one Scheduler, one PrefillWorker
        # and one DecodeWorker over all lanes, sharing this engine's clock
        sched = Scheduler(self)
        reqs, rejected = sched.validate(requests)
        B = self.slots
        clock = self.clock
        t0 = clock.now()
        gen = _generator(self.device, self.seed)
        self._caches = self.cache_init(self.num_pages, self.page_size)
        rs = self._new_run_state(sched, reqs, rejected)
        alloc, radix, inj, metrics = rs.alloc, rs.radix, rs.inj, rs.metrics
        stats = PoolStats()
        pw = PrefillWorker(self)
        dw = DecodeWorker(self, B, npag_max=self.npag_max)
        handoff = PageHandoff(alloc, self._release_pages, self.page_size)
        admissions = 0
        decode_steps = prefills = peak_conc = blocked = 0
        lookups = hits = tokens_saved = 0
        preempt_events = 0
        qd_samples: List[int] = []
        step = -1                        # engine step (admission or decode)

        def evict_lane(s: int, ncounts: np.ndarray) -> np.ndarray:
            """Take lane ``s`` out of service mid-flight: index its pages
            into the radix cache (so a requeue re-prefills warm), free
            them and null its device row. Returns the generated tokens."""
            rid = dw.slot_rid[s]
            gen_toks = host(dw.state["tokbuf"][s, :int(ncounts[s])])
            if radix is not None:
                self._index_sequence(rs, rid, gen_toks)
            self._release_pages(alloc, rid)
            dw.evict(s)
            dw.slot_rid[s] = None
            dw.active_host[s] = False
            return gen_toks

        def try_preempt(for_req: Request) -> bool:
            """Evict the Scheduler's victim (lowest priority; ties: latest
            admitted) and requeue it. False = nobody active is strictly
            lower priority than ``for_req``."""
            nonlocal preempt_events
            victim = sched.pick_victim(for_req, dw.slot_rid,
                                       dw.active_host, dw.admit_seq)
            if victim is None:
                return False
            ncounts = host(dw.state["ncount"])
            rid = dw.slot_rid[victim]
            gen_toks = evict_lane(victim, ncounts)
            metrics[rid].preemptions += 1
            preempt_events += 1
            self._requeue_or_fail(rs, rid, gen_toks, clock.now() - t0,
                                  "preempted")
            self._audit(rs)
            return True

        while sched.queue or dw.active_host.any():
            step += 1
            qd_samples.append(sched.queue_depth())
            if inj is not None:
                inj.begin_step(step, alloc, clock)
                self._audit(rs)
            # ---- Scheduler role: reap queued then active requests past SLO
            now_rel = clock.now() - t0
            self._reap_queued(rs, now_rel)
            doomed = sched.doomed_slots(now_rel, dw.slot_rid, dw.active_host)
            if doomed:
                ncounts = host(dw.state["ncount"])
                for s in doomed:
                    rid = dw.slot_rid[s]
                    m = metrics[rid]
                    cum = self._cumulative(rs, rid, evict_lane(s, ncounts))
                    m.outcome = "timed_out"
                    m.new_tokens = len(cum)
                    m.tokens = cum
                    m.finish_s = now_rel
                self._audit(rs)
            # ---- admission: lane + arrived request + enough pages; a
            # higher-priority arrival may preempt to make room for both
            while sched.queue:
                now_rel = clock.now() - t0
                req = sched.peek_best(now_rel)
                if req is None:
                    break
                if dw.active_host.all() and not try_preempt(req):
                    break
                if inj is not None and inj.refuse_alloc():
                    blocked += 1     # transient injected refusal: retry
                    break            # next engine step
                # PrefillWorker role: reserve under the prefill owner key
                got = pw.reserve(req, alloc, radix)
                if radix is not None:
                    lookups += 1
                while got is None and try_preempt(req):
                    got = pw.reserve(req, alloc, radix)
                if got is None:
                    blocked += 1     # queue head waits for retirements
                    break
                pages, s0 = got
                sched.take(req)
                prompt_np = np.asarray(req.prompt, np.int32)
                rs.prompt_of[req.rid] = prompt_np
                slot = dw.free_lane()
                m = metrics[req.rid]
                base = len(rs.partial.get(req.rid, ()))
                m.admitted_s = clock.now() - t0
                m.slot = slot
                m.cached_prompt_tokens = s0
                if s0 > 0:
                    hits += 1
                    tokens_saved += s0
                peak_conc = max(peak_conc, alloc.num_owners)
                btab_row = np.zeros(self.npag_max, np.int32)
                btab_row[:len(pages)] = pages
                btab_dev = torch.as_tensor(btab_row, device=self.device)[None]
                try:
                    if inj is not None:
                        inj.check_prefill()
                    logits, chunks = pw.prefill(prompt_np, btab_dev, clock,
                                                start=s0)
                except InjectedFault:
                    # contain the fault to this request: give back its
                    # pages (un-prefilled: check_prefill fires before any
                    # chunk writes) and retry or fail it alone
                    handoff.abort(req.rid)
                    self._audit(rs)
                    self._requeue_or_fail(rs, req.rid, np.zeros(0, np.int32),
                                          clock.now() - t0, "failed")
                    inj.note_prefill_resolved(step)
                    continue
                prefills += chunks
                if radix is not None:   # index the prompt's full pages
                    radix.insert(prompt_np, pages)
                tok0 = _sample_tokens(logits[:, -1:], gen, self.greedy)
                if base == 0:
                    m.first_token_s = clock.now() - t0
                m.new_tokens = base + 1
                done0 = req.max_new_tokens == 1
                if self.eos_id is not None:
                    done0 = done0 or int(tok0[0, 0]) == self.eos_id
                # PageHandoff role: decode takes ownership of the pages.
                # Interleaved, the lane picks the request up in the same
                # engine step, so handoff latency is zero by construction
                # (the disaggregated engine measures the real queue-wait)
                handoff.transfer(req.rid)
                handoff.latencies_s.append(0.0)
                dw.admit(tok0, btab_dev[0], slot, req.prompt_len,
                         req.max_new_tokens, not done0)
                dw.slot_tokens[slot] += 1
                admissions += 1
                dw.admit_seq[slot] = admissions
                if inj is not None:
                    inj.note_admission(step)
                if done0:
                    m.finished = True
                    m.outcome = "completed"
                    m.finish_s = clock.now() - t0
                    m.tokens = self._cumulative(
                        rs, req.rid, np.asarray([int(tok0[0, 0])], np.int32))
                    self._release_pages(alloc, req.rid)
                    self._audit(rs)
                else:
                    dw.active_host[slot] = True
                    dw.slot_rid[slot] = req.rid
            if not dw.active_host.any():
                if sched.queue:
                    # pool idle until the next arrival; when admission is
                    # blocked by an injected fault instead, fall through:
                    # the engine-step counter keeps advancing so timed
                    # faults (pressure windows, refusals) can drain
                    clock.wait_until(t0 + sched.next_arrival())
                    continue
                break
            # ---- DecodeWorker role: one fused step over all lanes
            t_step = clock.now()
            dw.note_step_start(t_step - t0)
            new_active, ncounts = dw.step(gen)
            dur = clock.now() - t_step
            dw.busy_s += dur
            decode_steps += 1
            for s in np.flatnonzero(dw.active_host):
                rid = dw.slot_rid[s]
                m = metrics[rid]
                base = len(rs.partial.get(rid, ()))
                m.token_latencies_s.append(dur)
                m.new_tokens = base + int(ncounts[s])
                dw.slot_tokens[s] += 1
                if not new_active[s]:         # EOS or budget: free pages
                    m.finished = True
                    m.outcome = "completed"
                    m.finish_s = clock.now() - t0
                    gen_toks = host(dw.state["tokbuf"][s, :int(ncounts[s])])
                    m.tokens = self._cumulative(rs, rid, gen_toks)
                    if radix is not None:
                        self._index_sequence(rs, rid, gen_toks)
                    self._release_pages(alloc, rid)
                    self._audit(rs)
                    dw.slot_rid[s] = None
            dw.active_host = new_active.copy() & dw.active_host
            dw.note_step_end(clock.now() - t0)
            live = sum(rs.plen_of[dw.slot_rid[s]] + int(ncounts[s])
                       for s in np.flatnonzero(dw.active_host))
            stats.sample(alloc, live)
        self._caches = None          # free the pool between runs
        return ServeReport(
            metrics=[metrics[r.rid] for r in (*reqs, *rejected)],
            scheduler=self.scheduler, slots=B,
            makespan_s=clock.now() - t0, decode_steps=decode_steps,
            prefills=prefills, slot_tokens=dw.slot_tokens,
            peak_concurrency=peak_conc, page_size=self.page_size,
            num_pages=self.num_pages,
            page_occupancy_mean=stats.occupancy_mean,
            page_occupancy_peak=stats.occupancy_peak,
            fragmentation_mean=stats.fragmentation_mean,
            fragmentation_peak=stats.fragmentation_peak,
            pages_high_water=alloc.high_water,
            failed_allocs=alloc.failed_allocs,
            admission_blocked_steps=blocked,
            prefix_enabled=self.prefix_cache,
            prefix_lookups=lookups, prefix_hits=hits,
            prefill_tokens_saved=tokens_saved,
            pages_shared_peak=stats.pages_shared_peak,
            prefix_evictions=radix.evictions if radix else 0,
            preemption_events=preempt_events, requeues=rs.requeues,
            pages_leaked=alloc.owned_pages,
            faults_injected=inj.injected if inj else 0,
            fault_recoveries=inj.recoveries if inj else 0,
            fault_recovery_steps=inj.recovery_steps() if inj else [],
            handoffs=handoff.handoffs,
            handoff_latencies_s=list(handoff.latencies_s),
            queue_depth_peak=max(qd_samples, default=0),
            queue_depth_mean=(float(sum(qd_samples) / len(qd_samples))
                              if qd_samples else 0.0),
            decode_stalls_s=list(dw.stalls_s))


SCHEDULERS["paged"] = PagedEngine
