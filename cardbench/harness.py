"""Runs one cell once and prints its result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. The harness
finds its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its correctness limits
(``limits/<cell>.json``), the driver of the mix's ``kind``
(``drivers/<kind>.py``) and the reader of each per-layer metric
(``metrics/<metric>.py``) by name, so a new cell, configuration, mix or
metric is new files and new entries, never an edit.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    root: Path
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclass
class Outcome:
    """What a driver hands back: its end-to-end readings, what the
    per-layer readers read (``counts``, ``trace``), the compared numbers
    with their limits, and the requests or steps attempted and failed."""
    end_to_end: dict
    counts: dict
    checks: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: object = None
    notes: list = field(default_factory=list)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_cell(root: Path, workload: str) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    w = cells[workload]
    base = root / "cardbench"
    config = _json(base / "configs" / f"{w['config']}.json")
    traffic = _json(base / "traffic" / f"{w['traffic']}.json")
    limits = _json(base / "limits" / f"{workload}.json")

    def here(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if here(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if here(m) and m["moves"] in names]
    return Cell(root, workload, w["chips"], config, traffic, limits, e2e,
                layer)


def driver(kind: str):
    return importlib.import_module(f"cardbench.drivers.{kind}")


def reader_path(root: Path, name: str) -> Path:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``."""
    path = root / "cardbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader of {name} under cardbench/metrics")
    return path


def reader(root: Path, name: str):
    path = reader_path(root, name)
    spec = importlib.util.spec_from_file_location(
        f"cardbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def result_line(cell: Cell, out: Outcome, trace: int, device_kind: str,
                count: int) -> dict:
    metrics = {}
    if trace:
        ctx = {"config": cell.config, "traffic": cell.traffic,
               "counts": out.counts, "trace": out.trace}
        for m in cell.per_layer:
            v = _finite(reader(cell.root, m["name"])(ctx))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = out.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": _finite(value), "unit": m["unit"]}
    checks = {n: {"value": _finite(v), "limit": lim}
              for n, v, lim in out.checks}
    correct = bool(out.checks) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values()) and out.failed == 0
    dev = {"platform": "gpu" if device_kind != "cpu" else "cpu",
           "kind": device_kind, "count": count,
           "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": correct, "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s()
        dev["window_s"] = out.trace.window_s
        line["breakdown"] = {"device_ops": out.trace.device_ops(),
                             "idle_gaps": out.trace.idle_gaps()}
    line["checks"] = checks
    return line


def run(cell: Cell, seed: int, seconds: float, trace: int, device,
        t_process: float) -> tuple:
    """One run of ``cell``: the driver's set-up, window and check. Returns
    the result line and the driver's notes."""
    import torch
    out = driver(cell.traffic["kind"]).run(
        cell, seed=seed, seconds=seconds, trace=bool(trace), device=device,
        t_process=t_process)
    gc.collect()
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    return result_line(cell, out, trace, kind, cell.chips), out.notes


def report(line: dict, notes=()) -> None:
    """Each compared number beside its limit as the last lines on
    standard error, then the result as the last line on standard out."""
    for note in notes:
        print(f"cardbench: {note}", file=sys.stderr)
    for n, c in line["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
