"""Trace schema: a serializable DAG of timed events, the counterpart of
``repro/trace/schema.py`` with the same JSON layout, key for key.

One :class:`Trace` is the record of one measured step (a train step, a
serving run, one scaling-matrix cell): a list of :class:`TraceEvent`
nodes whose ``deps`` edges form a DAG, plus the measured wall-clock
samples the DAG was decomposed from, the provenance of the cell
(arch/shape/mesh/devices), an environment fingerprint (the port's
``env_fingerprint()``, as its ``BenchRecord`` carries: traces from
different hosts are never silently comparable), and a schema version.

The JSON layout is flat (``json.dumps(trace.to_dict())``), so traces
cross the rank processes the scaling matrix runs on, land in
``results/traces_torch/`` and round-trip byte-stable through
:meth:`Trace.save` / :func:`load_trace`. The reference's traces load
here and the port's there.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Tuple

from repro_torch.bench.record import env_fingerprint

TRACE_SCHEMA_VERSION = 1

# event categories the replayer understands as parallel lanes
KINDS = ("compute", "memory", "collective", "prefill", "decode",
         "handoff", "host")


class TraceError(ValueError):
    """Malformed trace: duplicate/unknown event ids, cycles, bad costs."""


@dataclass
class TraceEvent:
    """One timed node of the DAG.

    ``kind`` is the resource lane (compute / memory / collective /
    prefill / decode / host), ``op`` the finer label (HLO opcode such as
    ``dot`` or ``all-reduce``, or a dispatch label), ``cost_s`` the time
    the event occupies its lane, and ``deps`` the event ids that must
    finish before this one starts.
    """

    eid: str
    kind: str
    op: str = ""
    cost_s: float = 0.0
    deps: Tuple[str, ...] = ()
    meta: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["deps"] = list(self.deps)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TraceEvent":
        return cls(
            eid=str(d["eid"]),
            kind=str(d.get("kind", "compute")),
            op=str(d.get("op", "")),
            cost_s=float(d.get("cost_s", 0.0)),
            deps=tuple(d.get("deps", ())),
            meta=dict(d.get("meta", {})),
        )


@dataclass
class Trace:
    """A captured, replayable step: DAG + measurement + provenance."""

    name: str
    kind: str = "train_step"  # train_step | serve | pp_step
    arch: str = ""
    shape: str = ""
    mesh: str = ""  # "2x4"-style (data x model)
    n_devices: int = 1
    measured_step_s: float = 0.0  # median of samples_s
    samples_s: List[float] = field(default_factory=list)
    events: List[TraceEvent] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)
    env: Dict[str, Any] = field(default_factory=env_fingerprint)
    version: int = TRACE_SCHEMA_VERSION

    # --------------------------------------------------------- validation
    def validate(self) -> None:
        """Raise :class:`TraceError` on structural problems the replayer
        cannot recover from (duplicate ids, dangling deps, negative
        costs). Cycles are detected by :func:`repro_torch.trace.replay.toposort`
        at replay time, where the offending ids can be named."""
        seen: set = set()
        for ev in self.events:
            if ev.eid in seen:
                raise TraceError(f"{self.name}: duplicate event id {ev.eid!r}")
            seen.add(ev.eid)
            if ev.cost_s < 0:
                raise TraceError(
                    f"{self.name}: event {ev.eid!r} has negative cost "
                    f"{ev.cost_s}"
                )
        for ev in self.events:
            for dep in ev.deps:
                if dep not in seen:
                    raise TraceError(
                        f"{self.name}: event {ev.eid!r} depends on unknown "
                        f"event {dep!r}"
                    )

    # ------------------------------------------------------------- lanes
    def lane_seconds(self, by: str = "kind") -> Dict[str, float]:
        """Total event cost per lane (kind) — the decomposed step.

        ``by="role"`` groups serve events by the serving role that
        dispatched them instead (``ev.meta["role"]``, falling back to the
        kind): under the disaggregated engine the same event kinds land
        on per-role lanes, which is what the interference comparison of
        ``trace_replay/serve_roles`` sums.
        """
        out: Dict[str, float] = {}
        for ev in self.events:
            key = ev.meta.get("role", ev.kind) if by == "role" else ev.kind
            out[key] = out.get(key, 0.0) + ev.cost_s
        return out

    def calibration(self, chip=None) -> Dict[str, float]:
        """Host-effective rates measured by this trace, for the
        trace-driven ``mesh_advisor.advise(..., calibration=...)`` mode.

        Derived from the per-lane decomposition: the effective FLOP/s is
        the trace's counted FLOPs over the time its compute lane took
        (ditto bytes/HBM and link traffic), and ``useful_flops_scale`` is
        counted FLOPs / analytic model FLOPs, the remat and attention
        overhead an analytic count misses. Lanes the trace never
        exercised fall back to ``chip``'s peak (default
        :data:`repro_torch.core.roofline.H100`; the compute peak of the
        trace's ``meta["dtype"]``, f32 where it has none) discounted by
        the overall measured/roofline ratio."""
        from repro_torch.core.roofline import H100

        chip = chip or H100
        lanes = self.lane_seconds()
        ratio = float(self.meta.get("calibration_ratio", 1.0)) or 1.0
        out: Dict[str, float] = {"calibration_ratio": ratio}

        def rate(amount_key: str, lane: str, peak: float) -> float:
            amount = float(self.meta.get(amount_key, 0.0))
            t = lanes.get(lane, 0.0)
            if amount > 0 and t > 0:
                return amount / t
            return peak / ratio

        out["flops_per_s"] = rate(
            "flops", "compute", chip.peak(self.meta.get("dtype", "float32")))
        out["hbm_bytes_per_s"] = rate("bytes", "memory", chip.hbm_bw)
        out["ici_bytes_per_s"] = rate("ici_bytes", "collective", chip.link_bw)
        model_flops = float(self.meta.get("model_flops", 0.0))
        flops_global = float(self.meta.get("flops", 0.0)) * self.n_devices
        if model_flops > 0 and flops_global > 0:
            out["useful_flops_scale"] = flops_global / model_flops
        return out

    # ------------------------------------------------------ serialization
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "kind": self.kind,
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "n_devices": self.n_devices,
            "measured_step_s": self.measured_step_s,
            "samples_s": list(self.samples_s),
            "events": [ev.to_dict() for ev in self.events],
            "meta": self.meta,
            "env": self.env,
            "version": self.version,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Trace":
        version = int(d.get("version", 0))
        if version > TRACE_SCHEMA_VERSION:
            raise TraceError(
                f"trace schema v{version} is newer than this reader "
                f"(v{TRACE_SCHEMA_VERSION})"
            )
        return cls(
            name=str(d["name"]),
            kind=str(d.get("kind", "train_step")),
            arch=str(d.get("arch", "")),
            shape=str(d.get("shape", "")),
            mesh=str(d.get("mesh", "")),
            n_devices=int(d.get("n_devices", 1)),
            measured_step_s=float(d.get("measured_step_s", 0.0)),
            samples_s=[float(s) for s in d.get("samples_s", ())],
            events=[TraceEvent.from_dict(e) for e in d.get("events", ())],
            meta=dict(d.get("meta", {})),
            env=dict(d.get("env", {})),
            version=version or TRACE_SCHEMA_VERSION,
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        return cls.from_dict(json.loads(text))

    def save(self, path: str | Path) -> Path:
        """Atomic write (tmp + rename), like the bench JSONL sink."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(self.to_json() + "\n")
        tmp.replace(path)
        return path


def load_trace(path: str | Path) -> Trace:
    trace = Trace.from_json(Path(path).read_text())
    trace.validate()
    return trace
