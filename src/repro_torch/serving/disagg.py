"""P/D-disaggregated serving: separate prefill and decode worker pools
over one shared page pool.

The PyTorch counterpart of ``repro/serving/disagg.py``. The interleaved
:class:`~repro_torch.serving.paged.PagedEngine` runs admission prefills and
decode steps on one timeline, so every chunked prefill stalls every
in-flight decode. :class:`DisaggregatedEngine` composes the same roles
(:mod:`repro_torch.serving.roles`) into separate pools:

* ``prefill_workers`` :class:`PrefillWorker`\\ s pull from the shared
  :class:`Scheduler` queue, reserve pages under the prefill owner key,
  chunk-prefill, and publish (request, first token, block table) to a
  ready set;
* ``decode_workers`` :class:`DecodeWorker`\\ s each own
  ``slots / decode_workers`` lanes; they accept ready requests through
  :meth:`PageHandoff.transfer` (page ownership moves prefill -> decode,
  refcount-conserving, no KV copy: one shared pool) and run fused decode
  steps that no prefill dispatch can interleave with.

Scheduling is event-driven over per-worker *virtual timelines*: the
engine clock meters each dispatch's cost and the cost is billed to the
acting worker's timeline; the next action always goes to the
earliest-runnable worker (prefill wins ties, mirroring the interleaved
engine's admission-first loop). Under
:class:`~repro_torch.serving.request.SimClock` this is a deterministic
simulation of N+M parallel workers; under a wall clock the timelines
degrade to measured sequential cost attribution (dispatches still issue
one at a time from one host process: the *schedule*, not host-level
parallelism, is what disaggregation changes).

Greedy outputs are token-identical to the interleaved paged engine:
per-lane decode math does not depend on the batch's composition, and
chunked prefill writes the same pages either way.

v1 limitation, as in the reference: no preemption (priority still orders
admission, but a decode lane is never evicted for a higher-priority
arrival). Deadlines, faults, the prefix cache and requeue-on-fault all
work.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.serving.engine import SCHEDULERS, _generator, _sample_tokens
from repro_torch.serving.faults import InjectedFault
from repro_torch.serving.pages import PoolStats
from repro_torch.serving.paged import PagedEngine
from repro_torch.serving.request import Request, ServeReport
from repro_torch.serving.roles import (DecodeWorker, PageHandoff,
                                       PrefillWorker, Scheduler, host)


class DisaggregatedEngine(PagedEngine):
    """Prefill/decode-disaggregated paged serving. ``slots`` is the
    *total* decode-lane count (equal-hardware comparisons against the
    interleaved engine hold it fixed) and must divide evenly across
    ``decode_workers``."""

    scheduler = "disaggregated"

    def __init__(self, *args, prefill_workers: int = 1,
                 decode_workers: int = 1, **kw):
        self.prefill_workers = int(prefill_workers)
        self.decode_workers = int(decode_workers)
        if self.prefill_workers < 1 or self.decode_workers < 1:
            raise ValueError(
                f"need >= 1 worker per role, got prefill_workers="
                f"{prefill_workers} decode_workers={decode_workers}")
        super().__init__(*args, **kw)
        if self.slots % self.decode_workers:
            raise ValueError(
                f"slots {self.slots} must divide evenly across "
                f"{self.decode_workers} decode workers")

    # -------------------------------------------------------------- run
    def run(self, requests: Sequence[Request]) -> ServeReport:
        sched = Scheduler(self)
        reqs, rejected = sched.validate(requests)
        clock = self.clock
        gen = _generator(self.device, self.seed)
        self._caches = self.cache_init(self.num_pages, self.page_size)
        rs = self._new_run_state(sched, reqs, rejected)
        alloc, radix, inj, metrics = rs.alloc, rs.radix, rs.inj, rs.metrics
        stats = PoolStats()
        handoff = PageHandoff(alloc, self._release_pages, self.page_size)
        lanes_per_dw = self.slots // self.decode_workers
        pws = [PrefillWorker(self, wid=w)
               for w in range(self.prefill_workers)]
        dws = [DecodeWorker(self, lanes_per_dw, wid=w,
                            npag_max=self.npag_max)
               for w in range(self.decode_workers)]
        # prefilled requests waiting for a decode lane (the handoff queue)
        ready: List[dict] = []
        qd_samples: List[int] = []
        admissions = 0
        decode_steps = prefills = peak_conc = blocked = 0
        lookups = hits = tokens_saved = 0
        step = -1

        def metered(fn, *args, **kw):
            """Run a dispatch, return (result, clock cost): the cost a
            worker bills to its own virtual timeline."""
            c0 = clock.now()
            out = fn(*args, **kw)
            return out, clock.now() - c0

        def injector_step(role: str, t: float) -> float:
            """Advance the fault schedule by one engine step billed to the
            acting worker's timeline (a slow_step stall charges the clock;
            that elapsed time lands on this worker alone)."""
            if inj is None:
                return t
            c0 = clock.now()
            inj.begin_step(step, alloc, clock, role=role)
            t += clock.now() - c0
            self._audit(rs)
            return t

        def decode_ready_t(d: DecodeWorker) -> float:
            """Earliest time decode worker ``d`` can act (inf = no work: no
            active lanes and nothing seatable in the ready set)."""
            if d.active_host.any():
                return d.t
            if ready and d.free_lane() is not None:
                return max(d.t, min(h["ready_t"] for h in ready))
            return float("inf")

        # ---- event loop over worker virtual timelines
        while sched.queue or ready or any(d.active_host.any() for d in dws):
            cands = []
            if sched.queue:
                pw = min(pws, key=lambda w: (w.t, w.wid))
                # 0 = prefill acts first on a tie, mirroring the
                # interleaved engine's admission-before-decode loop
                cands.append((max(pw.t, sched.next_arrival()), 0,
                              pw.wid, pw))
            for d in dws:
                t_d = decode_ready_t(d)
                if t_d != float("inf"):
                    cands.append((t_d, 1, d.wid, d))
            t_act, kind, _, w = min(cands, key=lambda c: c[:3])
            step += 1
            qd_samples.append(sched.queue_depth())

            if kind == 0:
                # ---------------------------------------- prefill action
                w.t = max(w.t, t_act)
                w.t = injector_step("prefill", w.t)
                now_rel = w.t
                self._reap_queued(rs, now_rel)
                req = sched.peek_best(now_rel)
                if req is None:
                    # nothing arrived yet: idle until the next arrival
                    if sched.queue:
                        w.t = max(w.t, sched.next_arrival())
                    continue
                if inj is not None and inj.refuse_alloc():
                    blocked += 1     # transient injected refusal: retry
                    continue
                got = w.reserve(req, alloc, radix)
                if radix is not None:
                    lookups += 1
                if got is None:
                    blocked += 1     # wait for decode-side retirements
                    pending = [d.t for d in dws if d.active_host.any()]
                    pending += [max(d.t, h["ready_t"]) for h in ready
                                for d in dws if d.free_lane() is not None]
                    if pending:
                        w.t = max(w.t, min(pending))
                    elif inj is None:
                        raise RuntimeError(
                            f"request {req.rid} cannot reserve pages and "
                            "no decode work is pending — the pool cannot "
                            "make progress")
                    # under an injector, fall through: the engine-step
                    # counter keeps advancing so pressure windows drain
                    continue
                pages, s0 = got
                sched.take(req)
                prompt_np = np.asarray(req.prompt, np.int32)
                rs.prompt_of[req.rid] = prompt_np
                m = metrics[req.rid]
                base = len(rs.partial.get(req.rid, ()))
                m.admitted_s = w.t
                m.prefill_worker = w.wid
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
                    (logits, chunks), cost = metered(
                        w.prefill, prompt_np, btab_dev, clock, start=s0)
                except InjectedFault:
                    handoff.abort(req.rid)
                    self._audit(rs)
                    self._requeue_or_fail(rs, req.rid, np.zeros(0, np.int32),
                                          w.t, "failed")
                    inj.note_prefill_resolved(step)
                    continue
                prefills += chunks
                w.t += cost
                w.busy_s += cost
                if radix is not None:
                    radix.insert(prompt_np, pages)
                tok0 = _sample_tokens(logits[:, -1:], gen, self.greedy)
                if base == 0:
                    m.first_token_s = w.t
                m.new_tokens = base + 1
                admissions += 1
                if inj is not None:
                    inj.note_admission(step)
                done0 = req.max_new_tokens == 1
                if self.eos_id is not None:
                    done0 = done0 or int(tok0[0, 0]) == self.eos_id
                if done0:
                    # completed at prefill: never reaches a decode lane, so
                    # the prefill-role hold is released, not handed off
                    m.finished = True
                    m.outcome = "completed"
                    m.finish_s = w.t
                    m.tokens = self._cumulative(
                        rs, req.rid, np.asarray([int(tok0[0, 0])], np.int32))
                    handoff.abort(req.rid)
                    self._audit(rs)
                else:
                    ready.append({"req": req, "tok0": tok0,
                                  "btab_row": btab_row, "base": base,
                                  "ready_t": w.t})
                continue

            # -------------------------------------------- decode action
            d = w
            d.t = max(d.t, t_act)
            d.t = injector_step("decode", d.t)
            # accept every ready handoff this worker can seat now
            while True:
                slot = d.free_lane()
                if slot is None:
                    break
                avail = [h for h in ready if h["ready_t"] <= d.t]
                if not avail:
                    break
                h = min(avail, key=lambda h: (h["ready_t"], h["req"].rid))
                ready.remove(h)
                req = h["req"]
                handoff.transfer(req.rid)
                _, cost = metered(clock.charge, "handoff")
                d.t += cost
                lat = d.t - h["ready_t"]
                handoff.latencies_s.append(lat)
                m = metrics[req.rid]
                m.handoff_latency_s = lat
                m.decode_worker = d.wid
                m.slot = d.wid * lanes_per_dw + slot
                d.admit(h["tok0"],
                        torch.as_tensor(h["btab_row"], device=self.device),
                        slot, req.prompt_len, req.max_new_tokens, True)
                d.slot_rid[slot] = req.rid
                d.active_host[slot] = True
                d.slot_tokens[slot] += 1
                d.admit_seq[slot] = admissions
            now_rel = d.t
            doomed = sched.doomed_slots(now_rel, d.slot_rid, d.active_host)
            if doomed:
                ncounts = host(d.state["ncount"])
                for s in doomed:
                    rid = d.slot_rid[s]
                    m = metrics[rid]
                    gen_toks = host(d.state["tokbuf"][s, :int(ncounts[s])])
                    if radix is not None:
                        self._index_sequence(rs, rid, gen_toks)
                    self._release_pages(alloc, rid)
                    d.slot_rid[s] = None
                    d.active_host[s] = False
                    d.evict(s)
                    cum = self._cumulative(rs, rid, gen_toks)
                    m.outcome = "timed_out"
                    m.new_tokens = len(cum)
                    m.tokens = cum
                    m.finish_s = now_rel
                self._audit(rs)
            if not d.active_host.any():
                # nothing seated (all ready_t in the future): jump ahead
                if ready:
                    d.t = max(d.t, min(h["ready_t"] for h in ready))
                continue
            d.note_step_start(d.t)
            (new_active, ncounts), cost = metered(d.step, gen)
            d.t += cost
            d.busy_s += cost
            decode_steps += 1
            for s in np.flatnonzero(d.active_host):
                rid = d.slot_rid[s]
                m = metrics[rid]
                base = len(rs.partial.get(rid, ()))
                m.token_latencies_s.append(cost)
                m.new_tokens = base + int(ncounts[s])
                d.slot_tokens[s] += 1
                if not new_active[s]:
                    m.finished = True
                    m.outcome = "completed"
                    m.finish_s = d.t
                    gen_toks = host(d.state["tokbuf"][s, :int(ncounts[s])])
                    m.tokens = self._cumulative(rs, rid, gen_toks)
                    if radix is not None:
                        self._index_sequence(rs, rid, gen_toks)
                    self._release_pages(alloc, rid)
                    self._audit(rs)
                    d.slot_rid[s] = None
            d.active_host = new_active.copy() & d.active_host
            d.note_step_end(d.t)
            live = sum(rs.plen_of[d.slot_rid[s]] + int(ncounts[s])
                       for s in np.flatnonzero(d.active_host))
            stats.sample(alloc, live)

        self._caches = None
        makespan = max([w.t for w in pws] + [d.t for d in dws] + [0.0])
        prefill_busy = sum(w.busy_s for w in pws)
        decode_busy = sum(d.busy_s for d in dws)
        denom = max(makespan, 1e-9)
        return ServeReport(
            metrics=[metrics[r.rid] for r in (*reqs, *rejected)],
            scheduler=self.scheduler, slots=self.slots,
            makespan_s=makespan, decode_steps=decode_steps,
            prefills=prefills,
            slot_tokens=np.concatenate([d.slot_tokens for d in dws]),
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
            preemption_events=0, requeues=rs.requeues,
            pages_leaked=alloc.owned_pages,
            faults_injected=inj.injected if inj else 0,
            fault_recoveries=inj.recoveries if inj else 0,
            fault_recovery_steps=inj.recovery_steps() if inj else [],
            prefill_workers=self.prefill_workers,
            decode_workers=self.decode_workers,
            prefill_busy_s=prefill_busy, decode_busy_s=decode_busy,
            prefill_util=prefill_busy / (self.prefill_workers * denom),
            decode_util=decode_busy / (self.decode_workers * denom),
            handoffs=handoff.handoffs,
            handoff_latencies_s=list(handoff.latencies_s),
            queue_depth_peak=max(qd_samples, default=0),
            queue_depth_mean=(float(sum(qd_samples) / len(qd_samples))
                              if qd_samples else 0.0),
            decode_stalls_s=[s for d in dws for s in d.stalls_s])


SCHEDULERS["disaggregated"] = DisaggregatedEngine
