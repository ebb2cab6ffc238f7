"""One runner for every benchmark of the port: timing, selection,
fail-soft errors, and result sinks. Copied from ``repro/bench/runner.py``;
the timer synchronises the card instead of blocking on JAX arrays, and
the subprocess runner with fake XLA devices is not ported.

* :func:`timeit_us` — the warmup + iters wall-clock timer, which waits for
  the device before each timer stops;
* :class:`BenchRunner` — iterates registered scenarios workload-by-
  workload, stamps each yielded record with scenario provenance and the
  environment fingerprint, captures per-workload failures as error
  records instead of aborting the sweep, and fans records out to sinks
  (CSV on stdout, JSONL under ``results/bench_torch/``, in-memory).
"""
from __future__ import annotations

import os
import signal
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, TextIO, Tuple

from repro_torch.bench.record import CSV_HEADER, BenchRecord, env_fingerprint
from repro_torch.bench.scenario import REGISTRY, Scenario, Workload, mesh_str
from repro_torch.core.metrics import percentile as _percentile


# ------------------------------------------------------------------ timing
class TimingStats(float):
    """Mean us-per-call that also carries the per-iteration samples.

    Drops in anywhere a plain float mean was expected; ``p50_us``/
    ``p95_us``/``samples`` ride along so records aren't skewed by warmup
    jitter hiding inside a mean.
    """

    samples: Tuple[float, ...]
    p50_us: float
    p95_us: float

    def __new__(cls, samples: Sequence[float]) -> "TimingStats":
        samples = tuple(samples)
        obj = super().__new__(cls, sum(samples) / len(samples))
        obj.samples = samples
        s = sorted(samples)
        obj.p50_us = _percentile(s, 50.0)
        obj.p95_us = _percentile(s, 95.0)
        return obj


def _sync() -> None:
    """Wait for every queued kernel: PyTorch returns before the card is
    done, so a host clock without this times the enqueue. Nothing to wait
    for where CUDA was never started."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit_us(fn, *args, iters: int = 5, warmup: int = 2) -> TimingStats:
    """Wall-clock microseconds per call after ``warmup`` calls, the device
    synchronised before each timer stops: a :class:`TimingStats` float
    (the mean) carrying per-iter samples."""
    iters = max(1, iters)
    for _ in range(warmup):
        fn(*args)
    _sync()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        samples.append((time.perf_counter() - t0) * 1e6)
    return TimingStats(samples)


# cap on per-record raw samples so JSONL lines stay bounded even for
# serving runs with hundreds of decode-step samples
MAX_RECORD_SAMPLES = 64


# ------------------------------------------------------------------- sinks
class ListSink:
    """Collect records in memory (``sink.records``)."""

    def __init__(self) -> None:
        self.records: List[BenchRecord] = []

    def emit(self, rec: BenchRecord) -> None:
        self.records.append(rec)

    def close(self) -> None:
        pass


class CsvStdoutSink:
    """The ``name,us_per_call,derived`` CSV stream."""

    def __init__(self, stream: Optional[TextIO] = None,
                 header: bool = True) -> None:
        self.stream = stream or sys.stdout
        if header:
            print(CSV_HEADER, file=self.stream, flush=True)

    def emit(self, rec: BenchRecord) -> None:
        print(rec.csv_line(), file=self.stream, flush=True)

    def close(self) -> None:
        pass


class JsonlSink:
    """Stream records to a JSONL file, atomically: lines go to a ``.tmp``
    sibling (flushed per record, so a live run is inspectable) and replace
    the target on close — a crashed or killed run never truncates the
    previous result set."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        self._fh = self._tmp.open("w")

    def emit(self, rec: BenchRecord) -> None:
        self._fh.write(rec.to_json_line() + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh.closed:
            return
        self._fh.close()
        os.replace(self._tmp, self.path)


# ------------------------------------------------------------------ runner
class ScenarioTimeout(Exception):
    """A workload exceeded the per-scenario wall-clock budget."""


class _workload_deadline:
    """SIGALRM-based wall-clock budget around one workload execution.

    A hung scenario (deadlocked collective, runaway decode loop) would
    otherwise stall the whole sweep; this turns it into a ``status:
    "timeout"`` record so the remaining scenarios still run. No-op when
    budget <= 0, off the main thread, or on platforms without SIGALRM —
    in those cases the workload simply runs unbounded as before.
    """

    def __init__(self, budget_s: float) -> None:
        self.budget_s = budget_s
        self.armed = False

    def __enter__(self) -> "_workload_deadline":
        if (self.budget_s > 0 and hasattr(signal, "SIGALRM")
                and threading.current_thread() is threading.main_thread()):
            self._prev = signal.signal(signal.SIGALRM, self._fire)
            signal.setitimer(signal.ITIMER_REAL, self.budget_s)
            self.armed = True
        return self

    def __exit__(self, *exc) -> None:
        if self.armed:
            signal.setitimer(signal.ITIMER_REAL, 0.0)
            signal.signal(signal.SIGALRM, self._prev)

    def _fire(self, signum, frame) -> None:
        raise ScenarioTimeout(
            f"workload exceeded {self.budget_s:.0f}s budget")


@dataclass
class RunSummary:
    records: List[BenchRecord] = field(default_factory=list)
    failures: List[Tuple[str, str]] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures


class BenchRunner:
    """Execute scenarios and fan records out to sinks."""

    #: default per-workload wall-clock budget (seconds); 0 disables
    DEFAULT_TIMEOUT_S = 600.0

    def __init__(self, sinks: Sequence[Any] = (),
                 env: Optional[Dict[str, Any]] = None,
                 timeout_s: Optional[float] = None) -> None:
        self.sinks = list(sinks)
        # by default the card where there is one: a run on the CPU passes
        # env_fingerprint("cpu")
        self.env = env_fingerprint() if env is None else env
        if timeout_s is None:
            timeout_s = float(os.environ.get(
                "REPRO_SCENARIO_TIMEOUT_S", self.DEFAULT_TIMEOUT_S))
        self.timeout_s = timeout_s

    # stamp scenario/workload provenance onto a record the fn yielded
    def _finalize(self, rec: BenchRecord, scen: Scenario,
                  wl: Workload) -> BenchRecord:
        rec.scenario = rec.scenario or scen.name
        rec.group = rec.group or scen.group
        rec.tags = rec.tags or scen.tags
        rec.paper_ref = rec.paper_ref or scen.paper_ref
        rec.arch = rec.arch or wl.arch
        if not rec.shape and wl.shape is not None:
            rec.shape = wl.shape.name
        rec.mesh = rec.mesh or mesh_str(wl.mesh)
        merged = dict(wl.knobs)
        merged.update(rec.knobs)
        rec.knobs = merged
        rec.env = rec.env or self.env
        # a TimingStats mean carries per-iter percentiles and the raw
        # samples the compare layer's sign test needs: stamp + strip
        us = rec.us_per_call
        if not rec.p50_us and hasattr(us, "p50_us"):
            rec.p50_us = float(us.p50_us)
            rec.p95_us = float(us.p95_us)
        if not rec.samples_us and hasattr(us, "samples"):
            # cap by striding over the WHOLE chronological sequence (not a
            # head slice): the compare sign test must see late-run samples
            # or a degradation tail could hide behind a fast warm start
            samples = us.samples
            if len(samples) > MAX_RECORD_SAMPLES:
                step = (len(samples) - 1) / (MAX_RECORD_SAMPLES - 1)
                samples = [samples[round(i * step)]
                           for i in range(MAX_RECORD_SAMPLES)]
            rec.samples_us = [round(float(s), 3) for s in samples]
        rec.us_per_call = float(us)
        return rec

    def _emit(self, rec: BenchRecord, out: RunSummary) -> None:
        out.records.append(rec)
        for sink in self.sinks:
            sink.emit(rec)

    def run(self, scenarios: Optional[Iterable[Scenario]] = None
            ) -> RunSummary:
        out = RunSummary()
        scens = list(scenarios) if scenarios is not None \
            else list(REGISTRY.values())
        for scen in scens:
            for wl in scen.workloads:
                label = f"/{wl.label}" if wl.label else ""
                try:
                    with _workload_deadline(self.timeout_s):
                        for rec in scen.fn(wl):
                            self._emit(self._finalize(rec, scen, wl), out)
                except ScenarioTimeout as e:  # hung: record, keep sweeping
                    out.failures.append(
                        (f"{scen.name}{label}", str(e)[:200]))
                    rec = BenchRecord(
                        name=f"{scen.name}{label}/TIMEOUT",
                        status="timeout", error=str(e)[:500],
                        derived={"timeout_s": self.timeout_s})
                    self._emit(self._finalize(rec, scen, wl), out)
                except Exception as e:  # fail-soft: record, keep sweeping
                    traceback.print_exc(file=sys.stderr)
                    out.failures.append(
                        (f"{scen.name}{label}", str(e)[:200]))
                    err = BenchRecord(
                        name=f"{scen.name}{label}/FAILED", status="error",
                        error="".join(traceback.format_exception_only(
                            type(e), e)).strip()[:500],
                        derived={"error": repr(e)[:200]})
                    self._emit(self._finalize(err, scen, wl), out)
        self.close()
        return out

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()
