"""Request-level serving engines on top of the model's prefill/decode steps.

The PyTorch counterpart of ``repro/serving/engine.py``. Two schedulers
over the same (prefill_fn, decode_fn, params) triple:

* :class:`StaticEngine`     — lockstep batches: requests are grouped into
  fixed batches in arrival order; a batch prefills together and decodes
  to the longest budget in the batch.
* :class:`ContinuousEngine` — continuous batching on a fixed pool of B KV
  slots: every decode step advances all occupied slots with per-slot
  positions; a request that hits EOS or its budget frees its slot
  mid-stream and the next queued request is admitted into it.

The engines keep the reference's host/device split: the per-slot state
and the token buffer live on the engine's device, the host reads back
only the per-slot ``active``/``ncount`` flags once per decode step (one
transfer), and every point where the reference blocks on the device
before reading the clock synchronises the device here.

Greedy decoding is ``argmax`` (ties to the lowest id, as ``jnp.argmax``);
sampling draws from ``torch.multinomial`` with a ``torch.Generator``
seeded from ``seed`` at the start of each run.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serving.request import Request, RequestMetrics, ServeReport
from repro_torch.serving.request import WallClock
from repro_torch.serving.roles import (PrefillWorker, Scheduler, host,
                                       lane_state, read_flags, sync)


def _sample_tokens(logits: torch.Tensor, gen: Optional[torch.Generator],
                   greedy: bool) -> torch.Tensor:
    """logits (..., V) -> int32 token ids with the leading shape of
    logits."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float(), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    tok = torch.multinomial(flat, 1, generator=gen)
    return tok.reshape(logits.shape[:-1]).to(torch.int32)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# ------------------------------------------------------------------ lockstep
def decode_lockstep(decode_step: Callable, params, caches, tok0, *,
                    start_pos: int, steps: int, greedy: bool = True,
                    gen: Optional[torch.Generator] = None, timer=None):
    """Lockstep decode: every row advances one token per step starting at
    ``start_pos``. Tokens accumulate in a device buffer that crosses to
    the host once, after the loop.

    With ``timer`` (a clock from :mod:`repro_torch.serving.request`), each
    step is synchronised and timed; ``step_times`` is then a list of
    per-step seconds. Returns ``(tokens, caches, step_times)`` with tokens
    a host ``(B, steps + 1)`` array (column 0 is ``tok0``)."""
    B = tok0.shape[0]
    buf = torch.zeros((B, steps + 1), dtype=torch.int32, device=tok0.device)
    buf[:, 0] = tok0[:, 0]
    tok = tok0
    times: Optional[List[float]] = [] if timer is not None else None
    for i in range(steps):
        t0 = timer.now() if timer is not None else 0.0
        logits, caches = decode_step(params, caches, tok, start_pos + i)
        tok = _sample_tokens(logits, gen, greedy)
        buf[:, i + 1] = tok[:, 0]
        if timer is not None:
            sync(tok.device)
            timer.charge("decode")
            times.append(timer.now() - t0)
    return buf.cpu().numpy(), caches, times


# -------------------------------------------------------------------- base
class _EngineBase:
    scheduler = "base"

    def __init__(self, prefill_fn: Callable, decode_fn: Callable, params,
                 cache_init: Callable, *, slots: int, cache_span: int,
                 eos_id: Optional[int] = None, greedy: bool = True,
                 seed: int = 0, clock=None, device="cuda"):
        self.params = params
        self.cache_init = cache_init
        self.slots = slots
        self.cache_span = cache_span
        self.eos_id = eos_id
        self.greedy = greedy
        self.seed = seed
        self.clock = clock or WallClock()
        self.device = torch.device(device)
        self._prefill_fn = prefill_fn
        self._decode_fn = decode_fn

    def _tokens_batch(self, prompts: np.ndarray) -> dict:
        """(b, prompt_len) int32 token prompts -> a prefill batch dict."""
        return {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                          device=self.device)}

    # ---- helpers shared by all schedulers
    def admission_error(self, r: Request) -> Optional[str]:
        """Why ``r`` can NEVER be served by this engine (None = servable).
        The one validation hook every scheduler routes through; the paged
        engine adds its page-pool capacity check."""
        if r.max_new_tokens < 1:
            return f"max_new_tokens must be >= 1, got {r.max_new_tokens}"
        if r.prompt_len + r.max_new_tokens > self.cache_span:
            return (f"prompt_len + max_new_tokens "
                    f"({r.prompt_len}+{r.max_new_tokens}) exceeds "
                    f"cache_span {self.cache_span}")
        return None

    def _validate(self, requests: Sequence[Request]) -> List[Request]:
        """Sort by arrival; raise ValueError on an impossible request."""
        reqs = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        for r in reqs:
            err = self.admission_error(r)
            if err:
                raise ValueError(f"request {r.rid}: {err}")
        return reqs

    @staticmethod
    def _make_metrics(reqs: Sequence[Request]) -> Dict[int, RequestMetrics]:
        return {r.rid: RequestMetrics(rid=r.rid, prompt_len=r.prompt_len,
                                      arrival_s=r.arrival_s)
                for r in reqs}

    def _prefill_one_batch(self, prompts: np.ndarray, gen):
        """Prefill (b, L) prompts; returns (tok0 (b,1), caches)."""
        batch = self._tokens_batch(prompts)
        logits, caches = self._prefill_fn(self.params, batch,
                                          self.cache_span)
        tok0 = _sample_tokens(logits[:, -1:], gen, self.greedy)
        sync(self.device)
        self.clock.charge("prefill")
        return tok0, caches

    def warmup(self, prompt_len: int) -> None:
        """Run one full slot pool of dummy requests outside the measured
        run (first-call costs: kernel build, allocator warm-up)."""
        budget = max(1, min(2, self.cache_span - prompt_len))
        self.run([Request(rid=-1 - i, prompt=np.ones(prompt_len, np.int32),
                          max_new_tokens=budget)
                  for i in range(self.slots)])

    def run(self, requests: Sequence[Request]) -> ServeReport:
        raise NotImplementedError


# ------------------------------------------------------------------ static
class StaticEngine(_EngineBase):
    """Lockstep batch-at-a-time scheduling. Each batch admits together
    (waiting for its slowest arrival), prefills together, and decodes to
    the longest budget in the batch; rows that finish early ride along.
    Requests within one batch must share a prompt length. Priorities are
    ignored; deadline misses are credited after the batch drains by
    :meth:`Scheduler.deadline_truncate`."""

    scheduler = "static"

    def run(self, requests: Sequence[Request]) -> ServeReport:
        sched = Scheduler(self)
        reqs = sched.validate(requests)
        B = self.slots
        clock = self.clock
        t0 = clock.now()
        gen = _generator(self.device, self.seed)
        metrics = self._make_metrics(reqs)
        slot_tokens = np.zeros(B, np.int64)
        decode_steps = prefills = peak_conc = 0

        for start in range(0, len(reqs), B):
            chunk = reqs[start:start + B]
            plens = {r.prompt_len for r in chunk}
            if len(plens) > 1:
                raise ValueError(
                    "StaticEngine requires equal prompt lengths within a "
                    f"batch, got {sorted(plens)} — bucket the workload or "
                    "use the continuous scheduler")
            clock.wait_until(t0 + max(r.arrival_s for r in chunk))
            t_adm = clock.now() - t0
            prompts = np.stack([np.asarray(r.prompt, np.int32)
                                for r in chunk])
            if len(chunk) < B:
                # pad a partial final batch to full width (dummy rows are
                # discarded) so every batch has the same shapes
                prompts = np.concatenate(
                    [prompts, np.repeat(prompts[:1], B - len(chunk), 0)])
            tok0, caches = self._prefill_one_batch(prompts, gen)
            prefills += 1
            peak_conc = max(peak_conc, len(chunk))
            t_first = clock.now() - t0
            budget_max = max(r.max_new_tokens for r in chunk)
            toks, caches, times = decode_lockstep(
                self._decode_fn, self.params, caches, tok0,
                start_pos=chunk[0].prompt_len, steps=budget_max - 1,
                greedy=self.greedy, gen=gen, timer=clock)
            decode_steps += budget_max - 1
            for i, r in enumerate(chunk):
                own = toks[i, :r.max_new_tokens]
                n = r.max_new_tokens
                if self.eos_id is not None:
                    hits = np.flatnonzero(own == self.eos_id)
                    if hits.size:
                        n = int(hits[0]) + 1
                m = metrics[r.rid]
                m.admitted_s, m.first_token_s = t_adm, t_first
                n, finish, timed_out = Scheduler.deadline_truncate(
                    t_first, times[:n - 1], r.deadline_abs_s)
                m.slot, m.new_tokens, m.tokens = i, n, own[:n]
                m.token_latencies_s = list(times[:n - 1])
                m.finish_s = finish
                if timed_out:
                    m.outcome = "timed_out"
                else:
                    m.finished = True
                    m.outcome = "completed"
                slot_tokens[i] += n
        return ServeReport(metrics=[metrics[r.rid] for r in reqs],
                           scheduler=self.scheduler, slots=B,
                           makespan_s=clock.now() - t0,
                           decode_steps=decode_steps, prefills=prefills,
                           slot_tokens=slot_tokens,
                           peak_concurrency=peak_conc)


# -------------------------------------------------------------- continuous
def _advance_lanes(state: dict, tok: torch.Tensor,
                   eos_id: Optional[int]) -> torch.Tensor:
    """The pool step's bookkeeping on the device, IN PLACE on ``state``:
    append each active lane's new token to its row of the token buffer,
    advance its position and count, and retire lanes that hit EOS or their
    budget. Returns the lanes still active."""
    active = state["active"]
    tokbuf = state["tokbuf"]
    B, T = tokbuf.shape
    bidx = torch.arange(B, device=tokbuf.device)
    idx = torch.clamp(state["ncount"], max=T - 1).long()
    tokbuf[bidx, idx] = torch.where(active, tok, tokbuf[bidx, idx])
    ncount = state["ncount"] + active.to(torch.int32)
    stop = ncount >= state["budget"]
    if eos_id is not None:
        stop = stop | (tok == eos_id)
    state["tok"][:, 0] = torch.where(active, tok, state["tok"][:, 0])
    state["pos"] += active.to(torch.int32)
    state["ncount"] = ncount
    still = active & ~stop
    state["active"] = still
    return still


def _admit_lane(state: dict, tok0: torch.Tensor, slot: int, plen: int,
                budget: int, active0: bool) -> None:
    """Set one lane's scheduler state for a newly admitted request."""
    t0 = tok0[0, 0]
    state["tok"][slot, 0] = t0
    state["pos"][slot] = plen
    state["active"][slot] = active0
    state["ncount"][slot] = 1
    state["budget"][slot] = budget
    state["tokbuf"][slot, 0] = t0


class ContinuousEngine(_EngineBase):
    """Continuous batching over a fixed pool of B KV slots.

    Device state per slot: last token, position, active flag, generated
    count, budget, and a row of the token buffer. One pool step decodes
    the whole pool with per-slot positions, samples, appends to the token
    buffer and retires slots that hit EOS or budget; the host reads back
    only the per-slot flags each step to drive admission."""

    scheduler = "continuous"

    def _pool_step(self, params, caches, state, gen):
        logits, caches = self._decode_fn(params, caches, state["tok"],
                                         state["pos"])
        tok = _sample_tokens(logits[:, -1], gen, self.greedy)      # (B,)
        _advance_lanes(state, tok, self.eos_id)
        return caches

    def _admit(self, caches, state, one, tok0, slot, plen, budget, active0):
        """Insert a prefilled request's caches into ``slot`` (IN PLACE)
        and set the slot's scheduler state."""
        for name, pool in caches["layers"].items():
            pool[:, slot] = one["layers"][name][:, 0]
        _admit_lane(state, tok0, slot, plen, budget, active0)

    def run(self, requests: Sequence[Request]) -> ServeReport:
        sched = Scheduler(self)
        reqs = sched.validate(requests)
        pw = PrefillWorker(self)
        B = self.slots
        clock = self.clock
        t0 = clock.now()
        gen = _generator(self.device, self.seed)
        caches = self.cache_init(B, self.cache_span)
        state = lane_state(B, self.cache_span, self.device)
        metrics = self._make_metrics(reqs)
        slot_rid: List[Optional[int]] = [None] * B
        active_host = np.zeros(B, bool)
        slot_tokens = np.zeros(B, np.int64)
        decode_steps = prefills = peak_conc = 0

        while sched.queue or active_host.any():
            # ---- Scheduler role: reap queued then active requests past SLO
            now_rel = clock.now() - t0
            for r in sched.reap_queued(now_rel):
                metrics[r.rid].outcome = "timed_out"
            doomed = sched.doomed_slots(now_rel, slot_rid, active_host)
            if doomed:
                _, ncounts = read_flags(state)
                for s in doomed:
                    m = metrics[slot_rid[s]]
                    m.outcome = "timed_out"
                    m.new_tokens = int(ncounts[s])
                    m.finish_s = now_rel
                    m.tokens = host(state["tokbuf"][s, :m.new_tokens])
                    slot_rid[s] = None
                    active_host[s] = False
                    # retire the lane on the device too
                    state["active"][s] = False
            # ---- admission: free slot + arrived request -> prefill into it
            while sched.queue and not active_host.all():
                req = sched.peek_best(clock.now() - t0)
                if req is None:
                    break
                sched.take(req)
                slot = int(np.flatnonzero(~active_host)[0])
                m = metrics[req.rid]
                m.admitted_s = clock.now() - t0
                m.slot = slot
                tok0, one = pw.prefill_batch(
                    np.asarray(req.prompt, np.int32)[None, :], gen)
                prefills += 1
                # the admitted request holds its slot's KV from here even
                # if it finishes on its first token
                peak_conc = max(peak_conc, int(active_host.sum()) + 1)
                m.first_token_s = clock.now() - t0
                m.new_tokens = 1
                # the first token only crosses to the host when the
                # scheduler must inspect it (EOS check / 1-token budget)
                done0 = req.max_new_tokens == 1
                if self.eos_id is not None:
                    done0 = done0 or int(tok0[0, 0]) == self.eos_id
                self._admit(caches, state, one, tok0, slot, req.prompt_len,
                            req.max_new_tokens, not done0)
                slot_tokens[slot] += 1        # the prefill-produced token
                if done0:
                    m.finished = True
                    m.outcome = "completed"
                    m.finish_s = m.first_token_s
                    m.tokens = np.asarray([int(tok0[0, 0])], np.int32)
                else:
                    active_host[slot] = True
                    slot_rid[slot] = req.rid
            if not active_host.any():
                if sched.queue:    # pool idle until the next arrival
                    clock.wait_until(t0 + sched.next_arrival())
                    continue
                break
            # ---- one decode step over the whole pool
            t_step = clock.now()
            caches = self._pool_step(self.params, caches, state, gen)
            sync(self.device)
            clock.charge("decode")
            dur = clock.now() - t_step
            decode_steps += 1
            new_active, ncounts = read_flags(state)
            for s in np.flatnonzero(active_host):
                m = metrics[slot_rid[s]]
                m.token_latencies_s.append(dur)
                m.new_tokens = int(ncounts[s])
                slot_tokens[s] += 1
                if not new_active[s]:           # EOS or budget: retire slot
                    m.finished = True
                    m.outcome = "completed"
                    m.finish_s = clock.now() - t0
                    m.tokens = host(state["tokbuf"][s, :m.new_tokens])
                    slot_rid[s] = None
            active_host = new_active.copy()
        return ServeReport(metrics=[metrics[r.rid] for r in reqs],
                           scheduler=self.scheduler, slots=B,
                           makespan_s=clock.now() - t0,
                           decode_steps=decode_steps, prefills=prefills,
                           slot_tokens=slot_tokens,
                           peak_concurrency=peak_conc)


SCHEDULERS = {"static": StaticEngine, "continuous": ContinuousEngine}


def make_engine(scheduler: str, prefill_fn, decode_fn, params, cache_init,
                **kw) -> _EngineBase:
    if scheduler not in SCHEDULERS:
        # the paged engine registers itself on import (kept out of this
        # module to avoid a circular import)
        import repro_torch.serving.paged  # noqa: F401
    try:
        cls = SCHEDULERS[scheduler]
    except KeyError:
        raise ValueError(f"unknown scheduler {scheduler!r}; "
                         f"expected one of {sorted(SCHEDULERS)}") from None
    return cls(prefill_fn, decode_fn, params, cache_init, **kw)
