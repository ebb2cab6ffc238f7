"""Blessed performance baselines for the port's benchmark harness, as
``repro/bench/baseline.py`` keeps them for the JAX package.

A *baseline* is a previously blessed :class:`BenchRecord` that future runs
are diffed against (:mod:`repro_torch.bench.compare`). Baselines are keyed
by (record name, backend, env fingerprint):

* one JSONL file per backend (``cuda`` or ``cpu``) under
  ``results/baselines_torch/<backend>.jsonl`` (``REPRO_TORCH_BASELINE_DIR``
  or ``--baseline-dir`` relocates the directory);
* within a file, one record per measurement name — blessing merges by
  name, overwriting the stale entry and keeping everything else;
* each stored record carries its env fingerprint; the compare layer skips
  (never fails) a pair whose fingerprints disagree, so a baseline blessed
  on one host, toolchain or card can never fail a run on another.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.bench.record import BenchRecord, read_jsonl, write_jsonl

DEFAULT_BASELINE_DIR = Path("results") / "baselines_torch"

# The env-fingerprint keys that must agree for two records to be
# comparable. A key missing on either side does not count as a mismatch.
# ``nvidia_smi`` holds the card's name and power limit.
FINGERPRINT_KEYS = (
    "python",
    "platform",
    "machine",
    "cpu",
    "torch",
    "cuda",
    "backend",
    "device_name",
    "device_count",
    "nvidia_smi",
)


def baseline_dir(override: Optional[str] = None) -> Path:
    """Resolve the baseline directory: explicit arg > env var > default."""
    if override:
        return Path(override)
    return Path(os.environ.get("REPRO_TORCH_BASELINE_DIR",
                               str(DEFAULT_BASELINE_DIR)))


def record_backend(rec: BenchRecord) -> str:
    return str(rec.env.get("backend", "cpu"))


def baseline_path(directory: Path, backend: str) -> Path:
    return Path(directory) / f"{backend}.jsonl"


def fingerprint(env: Dict[str, Any]) -> Dict[str, Any]:
    """The comparable subset of an env fingerprint."""
    return {k: env[k] for k in FINGERPRINT_KEYS if k in env}


def fingerprint_compatible(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    """True unless a key present on both sides disagrees."""
    for k in FINGERPRINT_KEYS:
        if k in a and k in b and a[k] != b[k]:
            return False
    return True


def load_baselines(
    directory: Path,
    backend: str = "cpu",
) -> Dict[str, BenchRecord]:
    """name -> blessed record for one backend; {} if never blessed."""
    path = baseline_path(directory, backend)
    if not path.exists():
        return {}
    return {rec.name: rec for rec in read_jsonl(path)}


def blessable(records: Iterable[BenchRecord]) -> List[BenchRecord]:
    """The subset of records worth persisting as baselines: successful,
    actually timed measurements (analytic / error / zero-time records
    would only ever compare as skips)."""
    return [
        r
        for r in records
        if r.status == "ok" and (r.us_per_call > 0 or r.p50_us > 0)
    ]


def bless(
    records: Iterable[BenchRecord],
    directory: Path,
) -> Dict[str, Path]:
    """Persist ``records`` as blessed baselines, merging by name into the
    per-backend file (existing entries for other names are kept; entries
    for the same name are overwritten). Returns backend -> file written.
    """
    by_backend: Dict[str, List[BenchRecord]] = {}
    for rec in blessable(records):
        by_backend.setdefault(record_backend(rec), []).append(rec)
    written: Dict[str, Path] = {}
    for backend, recs in sorted(by_backend.items()):
        merged = load_baselines(directory, backend)
        for rec in recs:
            merged[rec.name] = rec
        path = baseline_path(Path(directory), backend)
        write_jsonl([merged[k] for k in sorted(merged)], path)
        written[backend] = path
    return written
