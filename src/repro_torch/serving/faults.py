"""Deterministic fault injection for the serving engines.

Pure Python, copied from ``repro/serving/faults.py``: a plan fires at the
same engine steps in both packages.

A serving stack that has only ever been benchmarked at nominal load
tells you nothing about how it degrades — the interesting regime is
saturation, contention, and partial failure. This module makes that
regime *reproducible*: a :class:`FaultPlan` is data (seeded, like the
bench workloads), the engines consult it at step granularity through a
:class:`FaultInjector`, and every fault lands at exactly the same engine
step on every run.

Injectable fault kinds (``Fault.kind``):

* ``alloc_refusal``  — the next ``count`` page reservations are refused
  as if the pool were exhausted (transient; the queue head blocks and
  retries, exactly the real pool-pressure admission path);
* ``pool_pressure``  — ``pages`` usable pages are withheld from the
  allocator for ``duration`` engine steps (the free list shrinks without
  any allocation, forcing eviction/blocking on an otherwise-healthy
  pool);
* ``slow_step``      — the engine clock stalls ``stall_s`` seconds at
  one step (a straggler device; under SimClock this is deterministic
  virtual time, so deadline interactions are schedule-stable);
* ``prefill_error``  — the ``req_index``-th prefill dispatch raises
  :class:`InjectedFault` mid-admission (a poisoned kernel launch; the
  engine must fail or requeue *that request only* and release its
  pages);
* ``poison_pool``    — the allocator's bookkeeping is deliberately
  corrupted (a duplicate free-list entry). The engine must *detect* the
  corruption via :meth:`~repro_torch.serving.pages.PageAllocator.check` and
  call :meth:`FaultInjector.heal` to restore the invariant — proving
  the audit actually fires at the faulting step, not at shutdown.

The engine contract (gated by ``tests/test_torch_faults.py`` and
``chip_smoke.py`` phase 9): every fault either recovers (the affected
request is retried/requeued) or fails that one request; the pool passes
``check()`` after every fault; and surviving requests' greedy token
streams are **byte-identical** to a fault-free run — faults perturb
scheduling and timing, never numerics (the chaos-parity property).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.serving.pages import PageAllocator

FAULT_KINDS = ("alloc_refusal", "pool_pressure", "slow_step",
               "prefill_error", "poison_pool")


class InjectedFault(RuntimeError):
    """Raised by the injector inside an engine hot path (prefill_error).
    Engines catch exactly this type — a real exception still escapes."""


@dataclass(frozen=True)
class Fault:
    """One injectable event, keyed to an engine step.

    ``step`` counts *engine steps* — one per scheduler loop iteration
    (admission round or decode step), the granularity at which the
    engines consult the injector. Unused parameters are ignored per
    kind (see module docstring).
    """

    step: int
    kind: str
    count: int = 1          # alloc_refusal: reservations refused
    pages: int = 0          # pool_pressure: usable pages withheld
    duration: int = 1       # pool_pressure: steps the pressure lasts
    stall_s: float = 0.0    # slow_step: extra clock time
    req_index: int = 0      # prefill_error: k-th prefill dispatch raises

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")


@dataclass
class FaultPlan:
    """A deterministic schedule of faults — data, like bench workloads.

    Build one by hand for targeted tests, from
    :meth:`FaultPlan.default` for the standard chaos mix, or from a
    JSON file (``--fault-plan plan.json``) for custom sweeps.
    """

    faults: List[Fault] = field(default_factory=list)
    seed: int = 0

    @staticmethod
    def default(seed: int = 0) -> "FaultPlan":
        """The standard chaos mix: one fault of every kind, staggered
        across the early steps of a run (deterministic in ``seed`` —
        the seed shifts the schedule, not the composition)."""
        s = seed % 3
        return FaultPlan(seed=seed, faults=[
            Fault(step=1 + s, kind="alloc_refusal", count=2),
            Fault(step=4 + s, kind="pool_pressure", pages=2, duration=3),
            Fault(step=6 + s, kind="slow_step", stall_s=5.0),
            Fault(step=0, kind="prefill_error", req_index=2 + (seed % 2)),
            Fault(step=8 + s, kind="poison_pool"),
        ])

    # ------------------------------------------------------------ (de)ser
    def to_json(self, path: str | Path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(
            {"seed": self.seed, "faults": [asdict(f) for f in self.faults]},
            indent=2, sort_keys=True) + "\n")
        return path

    @staticmethod
    def from_json(path: str | Path) -> "FaultPlan":
        d = json.loads(Path(path).read_text())
        return FaultPlan(seed=int(d.get("seed", 0)),
                         faults=[Fault(**f) for f in d.get("faults", ())])


def resolve_fault_plan(spec: Optional[str],
                       seed: int = 0) -> Optional[FaultPlan]:
    """CLI/bench helper: ``None``/``"none"`` -> no plan, ``"default"``
    -> :meth:`FaultPlan.default`, anything else -> a JSON file path."""
    if spec is None or spec == "none":
        return None
    if spec == "default":
        return FaultPlan.default(seed)
    return FaultPlan.from_json(spec)


class FaultInjector:
    """Per-run state of a :class:`FaultPlan`: which faults have fired,
    which have recovered, and at what step. One injector per
    ``engine.run`` — the plan itself stays immutable data."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.events: List[Dict] = []      # {step, kind, recovered_step}
        self._fired: set = set()          # indices into plan.faults
        self._refusals_left = 0
        self._pressure: List[tuple] = []  # (until_step, pages, event)
        self._poison: Optional[tuple] = None   # (alloc, page) to undo
        self._prefill_faults: List[tuple] = [] # (req_index, event)
        self._prefills_seen = 0
        self._last_step = -1

    # ------------------------------------------------------------ queries
    @property
    def injected(self) -> int:
        return len(self.events)

    @property
    def recoveries(self) -> int:
        return sum(1 for e in self.events
                   if e["recovered_step"] is not None)

    def recovery_steps(self) -> List[int]:
        return [e["recovered_step"] - e["step"] for e in self.events
                if e["recovered_step"] is not None]

    def unrecovered(self) -> List[Dict]:
        return [e for e in self.events if e["recovered_step"] is None]

    # ------------------------------------------------------- step boundary
    def begin_step(self, step: int, alloc: PageAllocator, clock,
                   role: str = "engine") -> None:
        """Apply every fault scheduled at ``step`` (idempotent per step).
        The engine calls this once per scheduler loop iteration, then
        runs ``alloc.check()`` — poison faults are *meant* to make that
        check raise, see :meth:`heal`. ``role`` names which serving role
        drove the step ("prefill"/"decode" under the disaggregated
        engine, "engine" for the interleaved loops) and is recorded on
        every fault event fired this step."""
        if step <= self._last_step:
            return
        self._last_step = step
        # expire pool pressure that has run its duration
        live = [(until, pages, ev) for until, pages, ev in self._pressure
                if until > step]
        self._pressure = live
        alloc.pressure = sum(p for _, p, _ in live)
        for i, f in enumerate(self.plan.faults):
            if i in self._fired or f.step != step:
                continue
            self._fired.add(i)
            ev = {"step": step, "kind": f.kind, "role": role,
                  "recovered_step": None}
            self.events.append(ev)
            if f.kind == "alloc_refusal":
                self._refusals_left += f.count
            elif f.kind == "pool_pressure":
                self._pressure.append((step + f.duration, f.pages, ev))
                alloc.pressure = sum(p for _, p, _ in self._pressure)
            elif f.kind == "slow_step":
                clock.wait_until(clock.now() + f.stall_s)
                ev["recovered_step"] = step      # pure delay: no cleanup
            elif f.kind == "prefill_error":
                self._prefill_faults.append((f.req_index, ev))
            elif f.kind == "poison_pool":
                self._apply_poison(alloc)

    def _apply_poison(self, alloc: PageAllocator) -> None:
        """Corrupt the pool bookkeeping: duplicate a page onto the free
        list (an issued page when one exists — the nastier case)."""
        issued = sorted(set(alloc._refs))
        page = issued[0] if issued else alloc._free[-1]
        alloc._free.append(page)
        self._poison = (alloc, page)

    def heal(self, alloc: PageAllocator) -> bool:
        """Undo an active poison corruption; returns True when one was
        healed. The engine calls this when ``check()`` raises — a raise
        with *no* active poison is real corruption and must escape."""
        if self._poison is None or self._poison[0] is not alloc:
            return False
        _, page = self._poison
        alloc._free.remove(page)
        self._poison = None
        for e in reversed(self.events):
            if e["kind"] == "poison_pool" and e["recovered_step"] is None:
                e["recovered_step"] = self._last_step
                break
        return True

    # --------------------------------------------------------- admission
    def refuse_alloc(self) -> bool:
        """Consume one transient allocation refusal, if any is pending."""
        if self._refusals_left > 0:
            self._refusals_left -= 1
            return True
        return False

    def check_prefill(self) -> None:
        """Called once per prefill dispatch; raises :class:`InjectedFault`
        when this dispatch index is scheduled to fail."""
        idx = self._prefills_seen
        self._prefills_seen += 1
        for k, (req_index, ev) in enumerate(self._prefill_faults):
            if req_index == idx:
                del self._prefill_faults[k]
                self._open_prefill_event = ev
                raise InjectedFault(
                    f"injected prefill failure at dispatch {idx}")

    def note_prefill_resolved(self, step: int) -> None:
        """The request hit by a prefill_error was requeued or failed —
        either way the engine contained the fault."""
        ev = getattr(self, "_open_prefill_event", None)
        if ev is not None and ev["recovered_step"] is None:
            ev["recovered_step"] = step
            self._open_prefill_event = None

    def note_admission(self, step: int) -> None:
        """A reservation succeeded: any admission-blocking fault whose
        effect has drained (refusals consumed, pressure expired) is now
        recovered — the pool is serving again."""
        for e in self.events:
            if e["recovered_step"] is not None:
                continue
            if e["kind"] == "alloc_refusal" and not self._refusals_left:
                e["recovered_step"] = step
            elif e["kind"] == "pool_pressure" and not self._pressure:
                e["recovered_step"] = step
