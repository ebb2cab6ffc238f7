"""Composable serving roles: scheduler, prefill worker, decode worker,
and the page-ownership handoff between them.

The PyTorch counterpart of ``repro/serving/roles.py``:

* :class:`Scheduler`     — admission policy: arrival-aware priority
  queueing, deadline reaping (queued and in-flight), preemption victim
  choice, and the deadline-truncation rule every engine credits tokens by.
* :class:`PrefillWorker` — owns prefill compute: page reservation under
  the *prefill* role key (prefix-cache attach included) and the chunked
  prefill dispatches. The monolithic engines use its batch flavor.
* :class:`DecodeWorker`  — owns a pool of decode lanes: the fused
  pool-step device state (torch tensors on the engine's device), lane
  bookkeeping, a virtual timeline for disaggregated scheduling, and
  decode-stall samples.
* :class:`PageHandoff`   — the ownership transfer: prefill reserves pages
  under ``("prefill", rid)``, decode takes them over under plain ``rid``,
  refcount-conserving at every instant.

One *shared* page pool backs both roles, so the handoff is pure
bookkeeping (refcount +1/-1) and moves no KV. The interleaved engines
compose these roles in one loop;
:class:`repro_torch.serving.disagg.DisaggregatedEngine` runs separate
prefill and decode worker pools over the same roles.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.spans import span
from repro_torch.serving.pages import PageAllocator, PoolInvariantError
from repro_torch.serving.request import Request


def sync(device: torch.device) -> None:
    """Wait for the device before reading the clock (the reference's
    ``block_until_ready``): without it a CUDA timing covers only the
    enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RequestQueue:
    """Arrival-aware priority queue the continuous/paged schedulers admit
    from. Among *arrived* requests the highest ``priority`` wins; ties
    break by earliest arrival then lowest rid — so an all-default-priority
    workload admits in FIFO order. Requeues :meth:`push` back with a fresh
    arrival time."""

    def __init__(self, requests: Sequence[Request] = ()) -> None:
        self._items: List[Request] = list(requests)

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def push(self, req: Request) -> None:
        self._items.append(req)

    def remove(self, req: Request) -> None:
        self._items.remove(req)

    def next_arrival(self) -> float:
        return min(r.arrival_s for r in self._items)

    def peek_best(self, now_rel: float) -> Optional[Request]:
        """Highest-priority request that has arrived by ``now_rel``."""
        ready = [r for r in self._items if r.arrival_s <= now_rel]
        if not ready:
            return None
        return min(ready, key=lambda r: (-r.priority, r.arrival_s, r.rid))

    def pop_expired(self, now_rel: float) -> List[Request]:
        """Remove and return queued requests already past their deadline."""
        dead = [r for r in self._items
                if r.deadline_abs_s is not None and now_rel > r.deadline_abs_s]
        for r in dead:
            self._items.remove(r)
        return dead


# ------------------------------------------------------------------ handoff
def prefill_owner(rid: int) -> Tuple[str, int]:
    """Allocator owner key for pages held by the *prefill* role; the
    decode role holds under the plain ``rid``."""
    return ("prefill", rid)


class PageHandoff:
    """Transfer a request's pages from prefill to decode ownership.
    ``release_fn`` is the engine's ``_release_pages`` seam. The decode
    role attaches every page at +1 *before* the prefill hold drops its +1,
    so refcounts are conserved and a page is never transiently unowned."""

    def __init__(self, alloc: PageAllocator, release_fn,
                 page_size: int) -> None:
        self.alloc = alloc
        self._release = release_fn
        self.page_size = int(page_size)
        self.handoffs = 0
        self.latencies_s: List[float] = []

    def roles_of(self, rid: int) -> Tuple[bool, bool]:
        """(prefill holds, decode holds): the dual-ownership probe the
        handoff invariant tests assert on."""
        return (self.alloc.holds(prefill_owner(rid)), self.alloc.holds(rid))

    def transfer(self, rid: int) -> List[int]:
        """Move ``rid``'s pages from the prefill hold to the decode hold.
        Raises :class:`PoolInvariantError` on a double handoff or a handoff
        without a reservation. Returns the transferred block table."""
        pkey = prefill_owner(rid)
        if self.alloc.holds(rid):
            raise PoolInvariantError(
                f"handoff of rid {rid}: decode role already holds pages "
                "(double handoff?)")
        if not self.alloc.holds(pkey):
            raise PoolInvariantError(
                f"handoff of rid {rid}: prefill role holds no pages "
                "(handoff without reservation?)")
        pages = self.alloc.owned(pkey)
        self.alloc.allocate(rid, len(pages) * self.page_size, shared=pages)
        self._release(self.alloc, pkey)
        self.handoffs += 1
        return pages

    def abort(self, rid: int) -> None:
        """Release the prefill-role hold without transferring: the
        containment path for a failed prefill (the request's pages go
        straight back) and the completed-at-prefill path (a 1-token
        budget or first-token EOS never reaches a decode lane)."""
        pkey = prefill_owner(rid)
        if not self.alloc.holds(pkey):
            raise PoolInvariantError(
                f"abort of rid {rid}: prefill role holds no pages")
        self._release(self.alloc, pkey)


# ---------------------------------------------------------------- scheduler
class Scheduler:
    """The admission/reaping/preemption policy every engine routes through.
    Owns the queue and the rid -> current-Request map (a requeue swaps in
    the extended-prompt incarnation); the engines keep the device state."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self.queue = RequestQueue()
        self.req_of: Dict[int, Request] = {}
        self.has_deadlines = False

    def validate(self, requests: Sequence[Request]
                 ) -> Tuple[List[Request], List[Request]]:
        """Admission-validate ``requests`` through the engine's
        ``admission_error`` hook (via ``_validate``) and seed the queue
        with the servable ones. Returns (servable, rejected)."""
        ok, rejected = self.engine._validate(requests)
        self.queue = RequestQueue(ok)
        self.req_of = {r.rid: r for r in ok}
        self.has_deadlines = any(r.deadline_s is not None for r in ok)
        return ok, rejected

    def peek_best(self, now_rel: float) -> Optional[Request]:
        return self.queue.peek_best(now_rel)

    def take(self, req: Request) -> None:
        self.queue.remove(req)

    def requeue(self, req: Request) -> None:
        self.req_of[req.rid] = req
        self.queue.push(req)

    def next_arrival(self) -> float:
        return self.queue.next_arrival()

    def queue_depth(self) -> int:
        return len(self.queue)

    def reap_queued(self, now_rel: float) -> List[Request]:
        """Queued requests past their deadline (removed from the queue)."""
        if not self.has_deadlines:
            return []
        return self.queue.pop_expired(now_rel)

    def doomed_slots(self, now_rel: float, slot_rid: Sequence[Optional[int]],
                     active_host: np.ndarray) -> List[int]:
        """Active lanes whose request is past its deadline."""
        if not self.has_deadlines:
            return []
        return [int(s) for s in np.flatnonzero(active_host)
                if (d := self.req_of[slot_rid[s]].deadline_abs_s)
                is not None and now_rel > d]

    def pick_victim(self, for_req: Request,
                    slot_rid: Sequence[Optional[int]],
                    active_host: np.ndarray,
                    admit_seq: Sequence[int]) -> Optional[int]:
        """Lane to evict for ``for_req``: the lowest-priority active
        request (ties: latest admitted), and only if it is *strictly*
        lower priority. ``None`` = don't preempt."""
        cands = [int(s) for s in np.flatnonzero(active_host)]
        if not cands:
            return None
        victim = min(cands, key=lambda s: (
            self.req_of[slot_rid[s]].priority, -admit_seq[s]))
        if self.req_of[slot_rid[victim]].priority >= for_req.priority:
            return None
        return victim

    @staticmethod
    def deadline_truncate(t_first: float, step_times: Sequence[float],
                          deadline: Optional[float]
                          ) -> Tuple[int, float, bool]:
        """Credit tokens only up to the deadline. ``t_first`` is when token
        0 was ready and ``step_times`` the durations of the decode steps
        that produced tokens 1..N. Returns ``(n_tokens, finish_s,
        timed_out)``; the prefill token always counts."""
        if deadline is None:
            return len(step_times) + 1, t_first + float(sum(step_times)), False
        n, t = 1, t_first
        for dt in step_times:
            if t + dt > deadline:
                break
            t += dt
            n += 1
        timed_out = (t_first > deadline) or (n < len(step_times) + 1)
        return n, t, timed_out


# ------------------------------------------------------------------ workers
class PrefillWorker:
    """The prefill role: page reservation (under the prefill owner key)
    and the chunked prefill dispatches, with a virtual timeline for
    disaggregated scheduling. Compute stays on the engine's entry points;
    the worker owns whose clock the work bills to and the role-local
    counters."""

    def __init__(self, engine, wid: int = 0) -> None:
        self.engine = engine
        self.wid = wid
        self.t = 0.0                 # virtual timeline (disaggregated)
        self.busy_s = 0.0
        self.dispatches = 0

    def reserve(self, req: Request, alloc: PageAllocator, radix):
        """Reserve ``req``'s pages under the *prefill* role key (prefix
        attach included); ``None`` when the pool cannot cover it yet."""
        return self.engine._reserve_pages(req, alloc, radix,
                                          owner=prefill_owner(req.rid))

    def prefill(self, prompt: np.ndarray, btab_dev, clock, *,
                start: int = 0):
        """Chunk-prefill ``prompt[start:]`` into the reserved pages;
        returns (last chunk's logits, chunks dispatched)."""
        logits, chunks = self.engine._chunked_prefill(prompt, btab_dev,
                                                      clock, start=start)
        self.dispatches += chunks
        return logits, chunks

    def prefill_batch(self, prompts: np.ndarray, gen):
        """One-shot batch prefill; returns (tok0 (b, 1), caches)."""
        self.dispatches += 1
        return self.engine._prefill_one_batch(prompts, gen)


class DecodeWorker:
    """The decode role over ``lanes`` decode lanes: the fused pool-step
    device state (block-table flavored when ``npag_max`` is given), per-lane
    bookkeeping, a virtual timeline, and decode-stall samples (gaps
    between the end of one decode step and the start of the next while
    lanes stayed active: the time interleaved engines spend on admission
    prefills between decode steps, which P/D disaggregation removes)."""

    def __init__(self, engine, lanes: int, wid: int = 0,
                 npag_max: Optional[int] = None) -> None:
        self.engine = engine
        self.wid = wid
        self.lanes = lanes
        self.device = engine.device
        self.state = lane_state(lanes, engine.cache_span, self.device,
                                npag_max)
        self.slot_rid: List[Optional[int]] = [None] * lanes
        self.admit_seq = [0] * lanes     # admission order, victim choice
        self.active_host = np.zeros(lanes, bool)
        self.slot_tokens = np.zeros(lanes, np.int64)
        self.t = 0.0                 # virtual timeline (disaggregated)
        self.busy_s = 0.0
        self.steps = 0
        self.stalls_s: List[float] = []
        self._prev_end = 0.0
        self._carry = False

    def free_lane(self) -> Optional[int]:
        free = np.flatnonzero(~self.active_host)
        return int(free[0]) if free.size else None

    def note_step_start(self, now_rel: float) -> None:
        if self._carry:
            self.stalls_s.append(max(0.0, now_rel - self._prev_end))

    def note_step_end(self, now_rel: float) -> None:
        self._prev_end = now_rel
        self._carry = bool(self.active_host.any())

    def admit(self, tok0, btab_row, slot: int, plen: int, budget: int,
              active0: bool) -> None:
        self.engine._admit(self.state, tok0, btab_row, slot, plen, budget,
                           active0)

    def evict(self, slot: int) -> None:
        self.state["active"][slot] = False
        self.state["btab"][slot] = 0

    def step(self, gen):
        """One fused decode dispatch over this worker's lanes: runs the
        engine's pool step on the shared caches, synchronises, charges the
        clock. Returns host copies of (new_active, ncounts), read back in
        one transfer."""
        eng = self.engine
        with span("repro_torch.serve.decode_step"):
            eng._caches = eng._pool_step(eng.params, eng._caches, self.state,
                                         gen)
            sync(self.device)
            eng.clock.charge("decode")
            self.steps += 1
            return read_flags(self.state)


def lane_state(lanes: int, span: int, device: torch.device,
               npag_max: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The decode lanes' state on the device: last token, position, active
    flag, generated count, budget, a token buffer row sized by the cache
    span (an upper bound on any budget), and with ``npag_max`` a
    block-table row."""
    i32 = dict(dtype=torch.int32, device=device)
    state = {
        "tok": torch.zeros((lanes, 1), **i32),
        "pos": torch.zeros((lanes,), **i32),
        "active": torch.zeros((lanes,), dtype=torch.bool, device=device),
        "ncount": torch.zeros((lanes,), **i32),
        "budget": torch.ones((lanes,), **i32),
        "tokbuf": torch.zeros((lanes, span), **i32),
    }
    if npag_max is not None:
        state["btab"] = torch.zeros((lanes, npag_max), **i32)
    return state


def host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t``: on the CPU ``.numpy()`` alone would alias
    the live device state, which later steps overwrite."""
    return t.cpu().numpy().copy()


def read_flags(state) -> Tuple[np.ndarray, np.ndarray]:
    """(active, ncount) of every lane, in one device-to-host copy."""
    both = torch.stack([state["active"].to(torch.int32),
                        state["ncount"]]).cpu().numpy()
    return both[0].astype(bool), both[1]


__all__ = [
    "DecodeWorker",
    "PageHandoff",
    "PrefillWorker",
    "RequestQueue",
    "Scheduler",
    "prefill_owner",
    "host",
    "lane_state",
    "read_flags",
    "sync",
]
