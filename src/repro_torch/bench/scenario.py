"""Scenario registry: the paper's sweeps declared as data, copied from
``repro/bench/scenario.py`` with a registry of the port's own.

A *scenario* is a named, taggable experiment: a function that measures
one workload and yields :class:`~repro_torch.bench.record.BenchRecord`
rows, plus a list of :class:`Workload` cells (arch x ShapeConfig x
MeshConfig x knobs) declared as data, so the Table I-IV / Fig. 6-12
sweeps are visible in one place. Register with the decorator::

    @scenario("allocation/layers", tags=("tier1", "table1"),
              paper_ref="Table I / Fig. 6",
              workloads=[Workload(label=f"layers{L}", arch="granite-3-8b",
                                  knobs={"num_layers": L})
                         for L in (6, 12, 24, 48)])
    def allocation_layers(wl: Workload):
        ...
        yield BenchRecord(name=f"allocation/{wl.label}/O3", ...)

The runner (:mod:`repro_torch.bench.runner`) owns timing, fail-soft error
capture, and result sinks; scenario functions only measure and yield.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Mapping,
                    Optional, Sequence, Tuple)

from repro_torch.configs import MeshConfig, ShapeConfig

from repro_torch.bench.record import BenchRecord

# Default cell for scenarios that don't sweep shape/mesh: the reduced
# "bench" shape on the paper's 16x16 production mesh.
BENCH_SHAPE = ShapeConfig("bench", "train", 1024, 64)
BENCH_MESH = MeshConfig()


def mesh_str(mesh: Optional[MeshConfig]) -> str:
    return "x".join(map(str, mesh.shape)) if mesh is not None else ""


@dataclass(frozen=True)
class Workload:
    """One cell of a sweep: what to run, not how to time it."""

    label: str = ""                       # short suffix for record names
    arch: str = ""
    shape: Optional[ShapeConfig] = None
    mesh: Optional[MeshConfig] = None
    knobs: Mapping[str, Any] = field(default_factory=dict)


ScenarioFn = Callable[[Workload], Iterable[BenchRecord]]


@dataclass
class Scenario:
    name: str                             # unique id, e.g. "allocation/layers"
    fn: ScenarioFn
    group: str                            # family, e.g. "allocation"
    tags: Tuple[str, ...] = ()
    paper_ref: str = ""
    description: str = ""
    workloads: Tuple[Workload, ...] = (Workload(),)

    def __post_init__(self) -> None:
        if not self.workloads:
            self.workloads = (Workload(),)


REGISTRY: Dict[str, Scenario] = {}


def register(scen: Scenario) -> Scenario:
    if scen.name in REGISTRY:
        raise ValueError(f"scenario {scen.name!r} already registered")
    REGISTRY[scen.name] = scen
    return scen


def unregister(name: str) -> None:
    REGISTRY.pop(name, None)


def scenario(name: str, *, group: str = "", tags: Sequence[str] = (),
             paper_ref: str = "", description: str = "",
             workloads: Sequence[Workload] = ()) -> Callable[[ScenarioFn],
                                                             ScenarioFn]:
    """Decorator: register ``fn`` as a named scenario."""

    def deco(fn: ScenarioFn) -> ScenarioFn:
        register(Scenario(
            name=name, fn=fn,
            group=group or name.split("/", 1)[0],
            tags=tuple(tags), paper_ref=paper_ref,
            description=description or (fn.__doc__ or "").strip(),
            workloads=tuple(workloads) or (Workload(),)))
        return fn

    return deco


def names() -> List[str]:
    return sorted(REGISTRY)


def groups() -> List[str]:
    return sorted({s.group for s in REGISTRY.values()})


def only_matches(term: str, scen: Scenario) -> bool:
    """One ``--only`` term against one scenario. A term that is the *exact*
    name of a registered scenario selects only that scenario (so CI retries
    rerun one flaky scenario, not its whole group); any other term keeps
    the historical substring semantics over name and group."""
    if term in REGISTRY:
        return scen.name == term
    return term in scen.name or term in scen.group


def select(only: Optional[str] = None,
           tags: Optional[Sequence[str]] = None) -> Iterator[Scenario]:
    """Scenarios matching an ``--only`` filter and/or any of ``tags``, in
    registration order (which follows module order in bench.suites).
    ``only`` is a comma-separated list of terms, each resolved by
    :func:`only_matches` (exact scenario name > substring)."""
    want = set(tags or ())
    terms = [t for t in (only or "").split(",") if t]
    for scen in REGISTRY.values():
        if terms and not any(only_matches(t, scen) for t in terms):
            continue
        if want and not want.intersection(scen.tags):
            continue
        yield scen
