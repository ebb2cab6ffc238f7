"""DAG replay: predict step time by walking the trace, the counterpart of
``repro/trace/replay.py``.

The replayer runs an earliest-start schedule over the event DAG: an
event starts when its last dependency finishes and occupies its cost;
the predicted step time is the latest finish. With no edits this
reconstructs the recorded step (identity replay: the property the
``trace_replay/*`` records carry as ``rel_err`` per scaling-matrix
cell); with edits (:mod:`repro_torch.trace.whatif`) it answers what-if
questions — "step time if this op were twice as fast / this split were
2x4" — without running the config.

Edits are callables ``edit(event, cost_s) -> cost_s`` applied in order
to every event; costs can only be inspected and replaced, never the DAG
shape, so a replayed prediction is always over the captured dependency
structure. Halving any cost can therefore never increase the predicted
time (the monotonicity property the tests check).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence

from repro_torch.trace.schema import Trace, TraceError, TraceEvent

Edit = Callable[[TraceEvent, float], float]


@dataclass
class ReplayResult:
    """One replay: the prediction plus the schedule that produced it."""

    predicted_s: float
    finish_s: Dict[str, float]  # eid -> finish time
    critical_path: List[str]  # eids, source -> sink
    lane_s: Dict[str, float] = field(default_factory=dict)

    @property
    def dominant_lane(self) -> str:
        """Lane carrying the most critical-path time."""
        if not self.lane_s:
            return ""
        return max(self.lane_s, key=lambda k: self.lane_s[k])


def toposort(events: Sequence[TraceEvent]) -> List[TraceEvent]:
    """Kahn's algorithm over ``deps`` edges; events may arrive in any
    order. Raises :class:`TraceError` naming the stuck events on a
    cycle (and on dangling deps, via the indegree bookkeeping)."""
    by_id = {ev.eid: ev for ev in events}
    indeg: Dict[str, int] = {ev.eid: 0 for ev in events}
    out_edges: Dict[str, List[str]] = {ev.eid: [] for ev in events}
    for ev in events:
        for dep in ev.deps:
            if dep not in by_id:
                raise TraceError(
                    f"event {ev.eid!r} depends on unknown event {dep!r}"
                )
            indeg[ev.eid] += 1
            out_edges[dep].append(ev.eid)
    ready = deque(eid for eid, n in indeg.items() if n == 0)
    order: List[TraceEvent] = []
    while ready:
        eid = ready.popleft()
        order.append(by_id[eid])
        for nxt in out_edges[eid]:
            indeg[nxt] -= 1
            if indeg[nxt] == 0:
                ready.append(nxt)
    if len(order) != len(events):
        stuck = sorted(eid for eid, n in indeg.items() if n > 0)
        raise TraceError(f"dependency cycle through events {stuck}")
    return order


def replay(trace: Trace, *, edits: Sequence[Edit] = ()) -> ReplayResult:
    """Earliest-start walk over the DAG under optional cost edits."""
    trace.validate()
    order = toposort(trace.events)
    finish: Dict[str, float] = {}
    cost: Dict[str, float] = {}
    last_dep: Dict[str, str] = {}  # eid -> dep that gated its start
    for ev in order:
        c = ev.cost_s
        for edit in edits:
            c = float(edit(ev, c))
        if c < 0:
            raise TraceError(f"edit drove event {ev.eid!r} cost negative")
        start = 0.0
        for dep in ev.deps:
            if finish[dep] >= start:
                # ties resolve to the later-listed dep; any gating dep
                # yields a valid critical path
                start = finish[dep]
                last_dep[ev.eid] = dep
        cost[ev.eid] = c
        finish[ev.eid] = start + c
    if not finish:
        return ReplayResult(0.0, {}, [])
    sink = max(finish, key=lambda eid: finish[eid])
    path: List[str] = []
    cur: str | None = sink
    while cur is not None:
        path.append(cur)
        cur = last_dep.get(cur)
    path.reverse()
    by_id = {ev.eid: ev for ev in trace.events}
    lane_s: Dict[str, float] = {}
    for eid in path:
        kind = by_id[eid].kind
        lane_s[kind] = lane_s.get(kind, 0.0) + cost[eid]
    return ReplayResult(
        predicted_s=finish[sink],
        finish_s=finish,
        critical_path=path,
        lane_s=lane_s,
    )
