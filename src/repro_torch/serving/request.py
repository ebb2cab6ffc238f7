"""Request-level serving primitives: requests, per-request metrics, clocks.

Pure Python, copied from ``repro/serving/request.py``.

The paper's Tier-2 axis is deployment behavior; the unit of deployment is
a *request* (a prompt + a decode budget + an arrival time), not a batch.
Everything the scheduler reasons about and everything the benchmarks
record hangs off the two dataclasses here:

* :class:`Request`        — what arrives at the server;
* :class:`RequestMetrics` — what the server measured for it (TTFT,
  per-token latency, end-to-end latency), the LLM-Inference-Bench
  (arXiv 2411.00136) core metric set.

Clocks decouple *when things happen* from *how long compute takes*:
:class:`WallClock` measures real time (benchmark runs); :class:`SimClock`
charges a fixed cost per prefill/decode step (deterministic tests,
scheduler-policy comparisons independent of host noise).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Request:
    """One inference request: token prompt + decode budget + arrival.

    The SLO fields drive deadline and preemption scheduling:
    ``deadline_s`` is a per-request latency budget measured *from
    arrival* (the request must finish by ``arrival_s + deadline_s`` on
    the engine clock; ``None`` = no deadline); ``priority`` orders
    admission (higher wins) and decides who gets preempted under page
    pressure; ``max_retries`` bounds how many times a preempted request
    is requeued before it is failed outright.
    """

    rid: int
    prompt: np.ndarray              # (prompt_len,) int32 token ids
    max_new_tokens: int
    arrival_s: float = 0.0          # offered-load arrival time
    deadline_s: Optional[float] = None  # finish-by budget from arrival
    priority: int = 0               # higher = more important
    max_retries: int = 2            # requeues before outcome "failed"

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).shape[-1])

    @property
    def deadline_abs_s(self) -> Optional[float]:
        """Absolute finish-by time on the engine clock (run-relative)."""
        if self.deadline_s is None:
            return None
        return self.arrival_s + self.deadline_s


# terminal states a request can reach — what ``RequestMetrics.outcome``
# holds and what the ServeReport taxonomy counts
OUTCOMES = ("completed", "timed_out", "preempted", "rejected", "failed")


@dataclass
class RequestMetrics:
    """Measured lifecycle of one request (all times on the engine clock)."""

    rid: int
    prompt_len: int
    arrival_s: float
    admitted_s: float = 0.0         # when a slot/batch picked it up
    first_token_s: float = 0.0      # when its first token was ready
    finish_s: float = 0.0           # when its last token was ready
    new_tokens: int = 0             # tokens actually generated (<= budget)
    slot: int = -1                  # KV slot that served it
    finished: bool = False
    # terminal outcome ("" while in flight): completed | timed_out |
    # preempted (evicted, never resumed to completion) | rejected
    # (inadmissible, never scheduled) | failed (retries exhausted)
    outcome: str = ""
    preemptions: int = 0            # times evicted from a decode lane
    retries: int = 0                # times requeued after preemption
    # duration of each decode step that produced one of this request's
    # tokens (token 0 comes from prefill and is covered by TTFT)
    token_latencies_s: List[float] = field(default_factory=list)
    tokens: Optional[np.ndarray] = None   # (new_tokens,) generated ids

    @property
    def queue_s(self) -> float:
        return self.admitted_s - self.arrival_s

    @property
    def ttft_s(self) -> float:
        """Time to first token, from arrival (queueing + prefill)."""
        return self.first_token_s - self.arrival_s

    @property
    def e2e_s(self) -> float:
        return self.finish_s - self.arrival_s


# ------------------------------------------------------------------ clocks
class WallClock:
    """Real time: durations come from perf_counter, charge() is a no-op."""

    def now(self) -> float:
        return time.perf_counter()

    def charge(self, kind: str, n: int = 1) -> None:
        pass                         # wall time advances by itself

    def wait_until(self, t: float) -> None:
        d = t - self.now()
        if d > 0:
            time.sleep(d)


class SimClock:
    """Deterministic virtual time: each prefill/decode charges a fixed
    cost, waits jump. Scheduler comparisons under SimClock depend only on
    the schedule (admissions, step counts), never on host jitter."""

    def __init__(self, prefill_cost_s: float = 10.0,
                 decode_cost_s: float = 1.0) -> None:
        self._t = 0.0
        self._cost = {"prefill": prefill_cost_s, "decode": decode_cost_s}

    def now(self) -> float:
        return self._t

    def charge(self, kind: str, n: int = 1) -> None:
        self._t += self._cost[kind] * n

    def wait_until(self, t: float) -> None:
        self._t = max(self._t, t)


# ------------------------------------------------------------------ report
@dataclass
class ServeReport:
    """Aggregate result of one engine run over a request set."""

    metrics: List[RequestMetrics]
    scheduler: str                  # "static" | "continuous" | "paged"
    slots: int
    makespan_s: float               # first admission -> last token
    decode_steps: int
    prefills: int
    slot_tokens: np.ndarray         # (slots,) tokens generated per slot
    # max requests simultaneously holding KV memory (the headline the
    # paged engine moves: more admits at equal memory budget)
    peak_concurrency: int = 0
    # ---- paged-KV pool metrics (zero unless scheduler == "paged") ----
    page_size: int = 0
    num_pages: int = 0              # total pool incl. the null page
    page_occupancy_mean: float = 0.0   # allocated/usable, per decode step
    page_occupancy_peak: float = 0.0
    fragmentation_mean: float = 0.0    # 1 - live tokens / allocated slots
    fragmentation_peak: float = 0.0
    pages_high_water: int = 0          # peak pages simultaneously in use
    failed_allocs: int = 0             # pool-side allocation refusals
    admission_blocked_steps: int = 0   # steps the queue head waited on pages
    # ---- SLO enforcement + preemption -----------------------------
    preemption_events: int = 0         # evictions of an active request
    requeues: int = 0                  # preempted requests requeued
    pages_leaked: int = 0              # owner-held pages left at drain
    # gaps between consecutive decode steps while lanes stayed active
    # (the paged engine's prefill-interference metric)
    decode_stalls_s: List[float] = field(default_factory=list)

    @property
    def completed(self) -> int:
        return sum(1 for m in self.metrics if m.finished)

    def outcome_counts(self) -> dict:
        """Requests per terminal outcome (see ``OUTCOMES``)."""
        counts = {k: 0 for k in OUTCOMES}
        for m in self.metrics:
            key = m.outcome or ("completed" if m.finished else "")
            if key in counts:
                counts[key] += 1
        return counts

    @property
    def total_retries(self) -> int:
        return sum(m.retries for m in self.metrics)

    @property
    def total_new_tokens(self) -> int:
        return sum(m.new_tokens for m in self.metrics)

    @property
    def goodput_rps(self) -> float:
        """Completed requests per second of makespan."""
        return self.completed / max(self.makespan_s, 1e-9)

    @property
    def goodput_tps(self) -> float:
        """Generated tokens per second of makespan."""
        return self.total_new_tokens / max(self.makespan_s, 1e-9)

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode step —
        the serving analogue of the paper's Eq. 1 allocation ratio."""
        if self.decode_steps == 0:
            return 1.0 if self.total_new_tokens else 0.0
        useful = sum(len(m.token_latencies_s) for m in self.metrics)
        return useful / (self.slots * self.decode_steps)

    def ttft_samples_s(self) -> List[float]:
        return [m.ttft_s for m in self.metrics if m.finished]

    def token_latency_samples_s(self) -> List[float]:
        out: List[float] = []
        for m in self.metrics:
            out.extend(m.token_latencies_s)
        return out

    def summary(self) -> dict:
        """Flat dict of headline numbers (launcher stdout, BenchRecords)."""
        from repro_torch.core.metrics import percentile as pct
        from repro_torch.core.metrics import slot_load_balance

        tl = sorted(self.token_latency_samples_s())
        tt = sorted(self.ttft_samples_s())
        out = {
            "scheduler": self.scheduler,
            "completed": self.completed,
            "total_new_tokens": self.total_new_tokens,
            "makespan_s": self.makespan_s,
            "goodput_rps": self.goodput_rps,
            "goodput_tps": self.goodput_tps,
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "occupancy": self.occupancy,
            "peak_concurrency": self.peak_concurrency,
            "slot_balance": slot_load_balance(self.slot_tokens),
            "ttft_p50_s": pct(tt, 50.0),
            "ttft_p95_s": pct(tt, 95.0),
            "tok_p50_s": pct(tl, 50.0),
            "tok_p95_s": pct(tl, 95.0),
        }
        oc = self.outcome_counts()
        out.update({
            "n_timed_out": oc["timed_out"],
            "n_preempted": oc["preempted"],
            "n_rejected": oc["rejected"],
            "n_failed": oc["failed"],
            "preemption_events": self.preemption_events,
            "requeues": self.requeues,
            "retries": self.total_retries,
        })
        if self.num_pages:
            out.update({
                "page_size": self.page_size,
                "num_pages": self.num_pages,
                "page_occupancy_mean": self.page_occupancy_mean,
                "page_occupancy_peak": self.page_occupancy_peak,
                "fragmentation_mean": self.fragmentation_mean,
                "fragmentation_peak": self.fragmentation_peak,
                "pages_high_water": self.pages_high_water,
                "failed_allocs": self.failed_allocs,
                "admission_blocked_steps": self.admission_blocked_steps,
            })
        if self.decode_stalls_s:
            ds = sorted(self.decode_stalls_s)
            out.update({
                "decode_stall_p50_s": pct(ds, 50.0),
                "decode_stall_p95_s": pct(ds, 95.0),
            })
        return out
