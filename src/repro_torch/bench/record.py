"""BenchRecord: the one result type every benchmark of the port emits,
copied from ``repro/bench/record.py`` with an environment fingerprint
that reads torch and the card instead of JAX.

A record carries the full provenance of a measurement — which registered
scenario produced it, the (arch x shape x mesh) cell, the knob values the
sweep varied, the measured ``us_per_call``, and *structured* derived
metrics (a real dict, not a ``key=value`` string) — plus an environment
fingerprint so results from different hosts, toolchains and cards are
comparable.

Serialization targets:

* JSONL (``to_json_line``/``from_json_line`` + ``write_jsonl``/``read_jsonl``)
  — the machine-readable interchange the reporting layer consumes;
* CSV (``csv_line``) — the ``name,us_per_call,derived`` stdout format of
  ``python -m repro_torch.bench``.
"""
from __future__ import annotations

import dataclasses
import json
import platform
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

SCHEMA_VERSION = 2  # v2: per-iteration samples_us (empty = not measured)


def _cpu_model() -> str:
    """Best-effort CPU model string: hosts that differ only in their CPU
    must not compare as one."""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or ""


def nvidia_smi() -> str:
    """The first card's ``name, power.limit`` as ``nvidia-smi`` gives them
    (a card set below its full power runs slower under load); "" when
    ``nvidia-smi`` cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


def env_fingerprint(device: Optional[str] = None) -> Dict[str, Any]:
    """The machine, toolchain and device producing records on ``device``
    (``cuda`` or ``cpu``; by default the card where there is one): on a
    card also its name, the number of cards and ``nvidia-smi``'s name and
    power limit."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    env: Dict[str, Any] = {
        "python": platform.python_version(),
        "platform": sys.platform,
        "machine": platform.machine(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
        "backend": "cuda" if device.startswith("cuda") else "cpu",
    }
    cpu = _cpu_model()
    if cpu:
        env["cpu"] = cpu
    if env["backend"] == "cuda" and torch.cuda.is_available():
        env["device_name"] = torch.cuda.get_device_name(0)
        env["device_count"] = torch.cuda.device_count()
        env["nvidia_smi"] = nvidia_smi()
    return env


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


@dataclass
class BenchRecord:
    """One measurement from one scenario workload."""

    name: str                       # full measurement id, e.g. "allocation/layers12/O3"
    scenario: str = ""              # registered scenario id, e.g. "allocation/layers"
    group: str = ""                 # scenario family, e.g. "allocation"
    arch: str = ""
    shape: str = ""
    mesh: str = ""                  # "16x16"-style
    knobs: Dict[str, Any] = field(default_factory=dict)
    us_per_call: float = 0.0
    # per-iteration percentiles (0.0 = not measured). Serialized in JSONL;
    # the CSV keeps its mean-only `name,us_per_call,derived` shape.
    p50_us: float = 0.0
    p95_us: float = 0.0
    # raw per-iteration samples (microseconds, possibly capped by the
    # runner); the compare layer runs its sign test over these; empty =
    # not measured. JSONL only.
    samples_us: List[float] = field(default_factory=list)
    # serving scenarios: median time-to-first-token (0.0 = not a serving
    # measurement). JSONL only, like the percentiles.
    ttft_us: float = 0.0
    derived: Dict[str, Any] = field(default_factory=dict)
    tags: Tuple[str, ...] = ()
    paper_ref: str = ""             # "Table I / Fig. 6" etc.
    status: str = "ok"              # ok | error | timeout
    error: str = ""
    env: Dict[str, Any] = field(default_factory=dict)
    version: int = SCHEMA_VERSION

    # ------------------------------------------------------------- dict/json
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["tags"] = list(self.tags)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BenchRecord":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        kw["tags"] = tuple(kw.get("tags", ()))
        return cls(**kw)

    def to_json_line(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json_line(cls, line: str) -> "BenchRecord":
        return cls.from_dict(json.loads(line))

    # ------------------------------------------------------------------ CSV
    def derived_str(self) -> str:
        """Render derived metrics as the ``k=v;k2=v2`` string."""
        return ";".join(f"{k}={_fmt(v)}" for k, v in self.derived.items())

    def csv_line(self) -> str:
        return f"{self.name},{self.us_per_call:.1f},{self.derived_str()}"


CSV_HEADER = "name,us_per_call,derived"


def write_jsonl(records: Iterable[BenchRecord], path: str | Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fh:
        for rec in records:
            fh.write(rec.to_json_line() + "\n")
    return path


def read_jsonl(path: str | Path) -> List[BenchRecord]:
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            out.append(BenchRecord.from_json_line(line))
    return out
