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
tokens appended to the prompt) behave as in the reference. The prefix
cache (``prefix_cache=True``) and fault injection (``fault_plan``) come
in a later slice of the port; this engine raises ``ValueError`` for them.

Greedy outputs are token-identical to the monolithic engines: paging is a
memory-layout change, not a numerics change.

The engine takes the model's *paged* triple:
``prefill_fn(params, caches, tokens, block_tables, start_pos)``,
``decode_fn(params, caches, token, pos, block_tables)`` and
``cache_init(num_pages, page_size)``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.serving.engine import (SCHEDULERS, _admit_lane,
                                        _advance_lanes, _EngineBase,
                                        _generator, _sample_tokens)
from repro_torch.serving.pages import (PageAllocator, PoolStats,
                                       pages_needed)
from repro_torch.serving.request import Request, ServeReport
from repro_torch.serving.roles import (DecodeWorker, PageHandoff,
                                       PrefillWorker, Scheduler, host, sync)


class PagedEngine(_EngineBase):
    """Continuous batching over ``slots`` decode lanes and a paged KV
    pool of ``num_pages`` pages of ``page_size`` tokens (page 0 is the
    reserved null page). ``num_pages=None`` sizes the pool to the
    monolithic engine's budget (``slots x cache_span`` tokens) plus the
    null page. ``prefill_chunk_tokens=0`` prefills each prompt in one
    chunk."""

    scheduler = "paged"

    def __init__(self, prefill_fn, decode_fn, params, cache_init, *,
                 slots: int, cache_span: int, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefill_chunk_tokens: int = 0,
                 prefix_cache: bool = False, fault_plan=None, **kw):
        if prefix_cache:
            raise ValueError("prefix_cache=True: the prefix-sharing radix "
                             "cache is not ported yet (a later slice)")
        if fault_plan is not None:
            raise ValueError("fault_plan: fault injection is not ported yet "
                             "(a later slice)")
        self.page_size = int(page_size)
        # block-table width: logical pages a maximal request can touch
        self.npag_max = -(-cache_span // self.page_size)
        if num_pages is None:
            num_pages = slots * self.npag_max + 1
        self.num_pages = int(num_pages)
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
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

    # ----------------------------------------------------------- teardown
    def _release_pages(self, alloc: PageAllocator, rid) -> None:
        """Return a request's pages to the pool: the one seam every
        terminal path releases through."""
        alloc.free(rid)

    # ---------------------------------------------------------- prefill
    def _chunked_prefill(self, prompt: np.ndarray, btab_dev, clock, *,
                         start: int = 0):
        """Stream prompt positions ``[start, len)`` through the pool in
        chunks; returns the last chunk's logits and the number of chunks
        run. Each chunk sees only the first ``pages_needed(written)``
        pages of the block table, so attention cost grows with the live
        prefix rather than the full span."""
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
    def _reserve_pages(self, req: Request, alloc: PageAllocator, owner=None):
        """Reserve pages for ``req`` under ``owner`` (default: the rid).
        Returns ``(pages, suffix_start)`` or ``None`` when the pool cannot
        cover the request yet — the caller blocks the queue head until a
        retirement frees pages."""
        owner = req.rid if owner is None else owner
        total_tokens = req.prompt_len + req.max_new_tokens
        if not alloc.can_fit(total_tokens):
            return None
        return alloc.allocate(owner, total_tokens), 0

    # -------------------------------------------------------------- run
    def run(self, requests: Sequence[Request]) -> ServeReport:
        # role composition (interleaved): one Scheduler, one PrefillWorker
        # and one DecodeWorker over all lanes, sharing this engine's clock
        sched = Scheduler(self)
        reqs = sched.validate(requests)
        B = self.slots
        clock = self.clock
        t0 = clock.now()
        gen = _generator(self.device, self.seed)
        self._caches = self.cache_init(self.num_pages, self.page_size)
        alloc = PageAllocator(self.num_pages, self.page_size)
        stats = PoolStats()
        pw = PrefillWorker(self)
        dw = DecodeWorker(self, B, npag_max=self.npag_max)
        handoff = PageHandoff(alloc, self._release_pages, self.page_size)
        metrics = self._make_metrics(reqs)
        # plen_of tracks the *current* incarnation of each request (a
        # requeue replaces it with the extended-prompt version)
        plen_of = {r.rid: r.prompt_len for r in reqs}
        # tokens a preempted request generated before eviction — its
        # terminal metrics report the cumulative stream
        partial: Dict[int, np.ndarray] = {}
        admissions = 0
        decode_steps = prefills = peak_conc = blocked = 0
        preempt_events = requeues = 0

        def cumulative(rid: int, gen_toks: np.ndarray) -> np.ndarray:
            prev = partial.get(rid)
            gen_toks = np.asarray(gen_toks, np.int32)
            return gen_toks if prev is None else np.concatenate(
                [prev, gen_toks])

        def requeue_or_fail(rid: int, gen_toks: np.ndarray, now_rel: float,
                            exhausted_outcome: str) -> None:
            """Put an evicted request back in the queue with its
            generated-so-far tokens appended to its prompt (greedy
            re-prefill of the extended prompt reproduces the continuation
            exactly). After ``max_retries`` requeues it goes terminal."""
            nonlocal requeues
            r = sched.req_of[rid]
            m = metrics[rid]
            cum = cumulative(rid, gen_toks)
            m.retries += 1
            if m.retries > r.max_retries:
                m.outcome = exhausted_outcome
                m.finish_s = now_rel
                m.new_tokens = len(cum)
                m.tokens = cum
                return
            if len(gen_toks):
                partial[rid] = cum
            arrival = now_rel
            nr = Request(
                rid=rid,
                prompt=np.concatenate([np.asarray(r.prompt, np.int32),
                                       np.asarray(gen_toks, np.int32)]),
                max_new_tokens=r.max_new_tokens - len(gen_toks),
                arrival_s=arrival,
                # the absolute deadline survives the requeue
                deadline_s=(None if r.deadline_abs_s is None
                            else r.deadline_abs_s - arrival),
                priority=r.priority, max_retries=r.max_retries)
            plen_of[rid] = nr.prompt_len
            sched.requeue(nr)
            requeues += 1

        def evict_lane(s: int, ncounts: np.ndarray) -> np.ndarray:
            """Take lane ``s`` out of service mid-flight: free its pages
            and null its device row. Returns the generated tokens."""
            rid = dw.slot_rid[s]
            gen_toks = host(dw.state["tokbuf"][s, :int(ncounts[s])])
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
            requeue_or_fail(rid, gen_toks, clock.now() - t0, "preempted")
            return True

        while sched.queue or dw.active_host.any():
            # ---- Scheduler role: reap queued then active requests past SLO
            now_rel = clock.now() - t0
            for r in sched.reap_queued(now_rel):
                m = metrics[r.rid]
                m.outcome = "timed_out"
                cum = cumulative(r.rid, np.zeros(0, np.int32))
                if len(cum):          # progress from before eviction
                    m.new_tokens = len(cum)
                    m.tokens = cum
                    m.finish_s = now_rel
            doomed = sched.doomed_slots(now_rel, dw.slot_rid, dw.active_host)
            if doomed:
                ncounts = host(dw.state["ncount"])
                for s in doomed:
                    rid = dw.slot_rid[s]
                    m = metrics[rid]
                    cum = cumulative(rid, evict_lane(s, ncounts))
                    m.outcome = "timed_out"
                    m.new_tokens = len(cum)
                    m.tokens = cum
                    m.finish_s = now_rel
            # ---- admission: lane + arrived request + enough pages; a
            # higher-priority arrival may preempt to make room for both
            while sched.queue:
                now_rel = clock.now() - t0
                req = sched.peek_best(now_rel)
                if req is None:
                    break
                if dw.active_host.all() and not try_preempt(req):
                    break
                # PrefillWorker role: reserve under the prefill owner key
                got = pw.reserve(req, alloc)
                while got is None and try_preempt(req):
                    got = pw.reserve(req, alloc)
                if got is None:
                    blocked += 1     # queue head waits for retirements
                    break
                pages, s0 = got
                sched.take(req)
                prompt_np = np.asarray(req.prompt, np.int32)
                slot = dw.free_lane()
                m = metrics[req.rid]
                base = len(partial.get(req.rid, ()))
                m.admitted_s = clock.now() - t0
                m.slot = slot
                peak_conc = max(peak_conc, alloc.num_owners)
                btab_row = np.zeros(self.npag_max, np.int32)
                btab_row[:len(pages)] = pages
                btab_dev = torch.as_tensor(btab_row, device=self.device)[None]
                logits, chunks = pw.prefill(prompt_np, btab_dev, clock,
                                            start=s0)
                prefills += chunks
                tok0 = _sample_tokens(logits[:, -1:], gen, self.greedy)
                if base == 0:
                    m.first_token_s = clock.now() - t0
                m.new_tokens = base + 1
                done0 = req.max_new_tokens == 1
                if self.eos_id is not None:
                    done0 = done0 or int(tok0[0, 0]) == self.eos_id
                # PageHandoff role: decode takes ownership of the pages in
                # the same engine step
                handoff.transfer(req.rid)
                dw.admit(tok0, btab_dev[0], slot, req.prompt_len,
                         req.max_new_tokens, not done0)
                dw.slot_tokens[slot] += 1
                admissions += 1
                dw.admit_seq[slot] = admissions
                if done0:
                    m.finished = True
                    m.outcome = "completed"
                    m.finish_s = clock.now() - t0
                    m.tokens = cumulative(
                        req.rid, np.asarray([int(tok0[0, 0])], np.int32))
                    self._release_pages(alloc, req.rid)
                else:
                    dw.active_host[slot] = True
                    dw.slot_rid[slot] = req.rid
            if not dw.active_host.any():
                if sched.queue:
                    clock.wait_until(t0 + sched.next_arrival())
                    continue
                break
            # ---- DecodeWorker role: one fused step over all lanes
            t_step = clock.now()
            dw.note_step_start(t_step - t0)
            new_active, ncounts = dw.step(gen)
            dur = clock.now() - t_step
            decode_steps += 1
            for s in np.flatnonzero(dw.active_host):
                rid = dw.slot_rid[s]
                m = metrics[rid]
                base = len(partial.get(rid, ()))
                m.token_latencies_s.append(dur)
                m.new_tokens = base + int(ncounts[s])
                dw.slot_tokens[s] += 1
                if not new_active[s]:         # EOS or budget: free pages
                    m.finished = True
                    m.outcome = "completed"
                    m.finish_s = clock.now() - t0
                    gen_toks = dw.state["tokbuf"][s, :int(ncounts[s])]
                    m.tokens = cumulative(rid, host(gen_toks))
                    self._release_pages(alloc, rid)
                    dw.slot_rid[s] = None
            dw.active_host = new_active.copy() & dw.active_host
            dw.note_step_end(clock.now() - t0)
            live = sum(plen_of[dw.slot_rid[s]] + int(ncounts[s])
                       for s in np.flatnonzero(dw.active_host))
            stats.sample(alloc, live)
        self._caches = None          # free the pool between runs
        return ServeReport(
            metrics=[metrics[r.rid] for r in reqs],
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
            preemption_events=preempt_events, requeues=requeues,
            pages_leaked=alloc.owned_pages,
            decode_stalls_s=list(dw.stalls_s))


SCHEDULERS["paged"] = PagedEngine
