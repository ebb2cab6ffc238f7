"""Noise-aware baseline comparison: the regression gate behind
``python -m repro_torch.bench --compare``, copied from
``repro/bench/compare.py``.

Each fresh :class:`BenchRecord` is diffed against the blessed baseline of
the same name (:mod:`repro_torch.bench.baseline`). A record only *regresses*
when two independent signals agree:

1. **p50 ratio** — the fresh median is more than ``rel_tol`` slower than
   the blessed median (falling back to the mean when percentiles were not
   measured);
2. **sign test** — under the null hypothesis "nothing changed", each
   fresh per-iteration sample lands above the blessed median with
   probability 1/2; the one-sided binomial tail over the fresh
   ``samples_us`` must reach ``alpha``, or every sample must sit above
   the old median (unanimity leaves no contrary evidence to call noise,
   even when n is too small for significance). With the default 5 bench
   iterations that means *every* sample must sit above the old median —
   a single noisy spike inflating the mean can never fail the gate (it
   reports ``noisy`` instead). Records without samples fall back to the
   ratio alone.

Comparisons are *skipped* (never failed) when the env fingerprints
disagree, when the baseline is missing (``new``), or when the measurement
is below ``min_us`` (pure timer noise).

Every compare appends one point to ``results/trajectory_torch.jsonl``,
the port's per-commit performance trajectory.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.bench.baseline import fingerprint, fingerprint_compatible
from repro_torch.bench.record import BenchRecord

DEFAULT_TRAJECTORY = Path("results") / "trajectory_torch.jsonl"

# verdicts, ordered worst-first for reporting
REGRESSION = "regression"
NOISY = "noisy"  # ratio breached but the sign test says noise
OK = "ok"
FASTER = "faster"
NEW = "new"  # no baseline for this name yet
SKIPPED = "skipped"  # fingerprint mismatch / untimed / error record

_ORDER = (REGRESSION, NOISY, FASTER, OK, NEW, SKIPPED)


@dataclass(frozen=True)
class Thresholds:
    """Knobs of the noise-aware gate (see module docstring)."""

    rel_tol: float = 0.25  # p50 must be >25% slower to regress
    alpha: float = 0.05  # one-sided sign-test significance
    min_us: float = 50.0  # ignore sub-50us baselines: timer noise
    min_samples: int = 4  # fewer samples -> ratio-only verdict
    # sample-less records have no sign-test veto, so single-shot jitter
    # (routinely 25-50% on shared hosts) must not read as regression:
    # demand a much larger breach before failing on the ratio alone
    ratio_only_tol: float = 0.6


def sign_test_p(n_above: int, n: int) -> float:
    """One-sided binomial tail P[X >= n_above], X ~ Bin(n, 1/2)."""
    if n <= 0:
        return 1.0
    total = sum(math.comb(n, k) for k in range(n_above, n + 1))
    return total / float(2**n)


def _rep_us(rec: BenchRecord) -> float:
    """The representative latency: median when measured, else the mean."""
    return rec.p50_us if rec.p50_us > 0 else rec.us_per_call


@dataclass
class CompareResult:
    name: str
    status: str
    ratio: float = 0.0  # fresh / baseline representative latency
    base_us: float = 0.0
    fresh_us: float = 0.0
    detail: str = ""

    def line(self) -> str:
        r = f"{self.ratio:.3f}x" if self.ratio else "-"
        tail = f"  ({self.detail})" if self.detail else ""
        return (
            f"{self.status:10s} {self.name:44s} "
            f"{self.base_us:12.1f} -> {self.fresh_us:12.1f}  {r}{tail}"
        )


def compare_record(
    fresh: BenchRecord,
    base: Optional[BenchRecord],
    thr: Thresholds = Thresholds(),
) -> CompareResult:
    """Diff one fresh record against its blessed baseline."""
    res = CompareResult(name=fresh.name, status=OK)
    if fresh.status != "ok":
        res.status, res.detail = SKIPPED, "fresh record is an error record"
        return res
    if base is None:
        res.status = NEW
        return res
    if not fingerprint_compatible(fingerprint(fresh.env), fingerprint(base.env)):
        res.status = SKIPPED
        res.detail = "env fingerprint mismatch"
        return res
    base_us, fresh_us = _rep_us(base), _rep_us(fresh)
    res.base_us, res.fresh_us = base_us, fresh_us
    if base_us <= 0 or fresh_us <= 0:
        res.status, res.detail = SKIPPED, "untimed measurement"
        return res
    if base_us < thr.min_us:
        res.status = SKIPPED
        res.detail = f"baseline below min_us={thr.min_us:g}"
        return res
    res.ratio = fresh_us / base_us
    if res.ratio < 1.0 / (1.0 + thr.rel_tol):
        res.status = FASTER
        return res
    if res.ratio <= 1.0 + thr.rel_tol:
        return res
    samples = fresh.samples_us
    if len(samples) < thr.min_samples:
        if res.ratio > 1.0 + thr.ratio_only_tol:
            res.status = REGRESSION
            res.detail = f"ratio-only verdict ({len(samples)} samples)"
        else:
            res.status = NOISY
            res.detail = (
                f"ratio breach without samples (needs "
                f">{1.0 + thr.ratio_only_tol:g}x, got {res.ratio:.2f}x)"
            )
        return res
    n_above = sum(1 for s in samples if s > base_us)
    n = len(samples)
    p = sign_test_p(n_above, n)
    # unanimity clause: when EVERY sample sits above the old median there
    # is no contrary evidence to call noise, so a breached ratio regresses
    # even when n is too small for p <= alpha (4 samples: p = 1/16)
    if p <= thr.alpha or n_above == n:
        res.status = REGRESSION
        res.detail = f"sign test {n_above}/{n} above, p={p:.4f}"
    else:
        res.status = NOISY
        res.detail = f"sign test {n_above}/{n} above, p={p:.4f}"
    return res


@dataclass
class CompareReport:
    results: List[CompareResult] = field(default_factory=list)
    thresholds: Thresholds = Thresholds()

    def by_status(self, status: str) -> List[CompareResult]:
        return [r for r in self.results if r.status == status]

    @property
    def regressions(self) -> List[CompareResult]:
        return self.by_status(REGRESSION)

    @property
    def ok(self) -> bool:
        return not self.regressions

    def counts(self) -> Dict[str, int]:
        return {s: len(self.by_status(s)) for s in _ORDER}

    def geomean_ratio(self) -> float:
        """Geometric mean of fresh/base over actually compared records."""
        ratios = [
            r.ratio
            for r in self.results
            if r.ratio > 0 and r.status in (OK, FASTER, REGRESSION, NOISY)
        ]
        if not ratios:
            return 0.0
        return math.exp(sum(math.log(x) for x in ratios) / len(ratios))

    def lines(self, verbose: bool = False) -> List[str]:
        """Human-readable report: all non-ok verdicts, plus a summary."""
        shown = [
            r
            for r in sorted(self.results, key=lambda r: _ORDER.index(r.status))
            if verbose or r.status in (REGRESSION, NOISY, FASTER)
        ]
        out = [r.line() for r in shown]
        c = self.counts()
        gm = self.geomean_ratio()
        out.append(
            "compare: "
            + " ".join(f"{k}={v}" for k, v in c.items() if v)
            + (f" geomean_ratio={gm:.3f}" if gm else "")
        )
        return out

    def trajectory_point(
        self, extra: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        c = self.counts()
        point: Dict[str, Any] = {
            "t": round(time.time(), 3),
            "compared": sum(c[s] for s in (OK, FASTER, REGRESSION, NOISY)),
            "regressions": [r.name for r in self.regressions],
            "geomean_ratio": round(self.geomean_ratio(), 4),
            "counts": {k: v for k, v in c.items() if v},
        }
        if extra:
            point.update(extra)
        return point


def compare_records(
    fresh: Iterable[BenchRecord],
    baselines: Dict[str, BenchRecord],
    thr: Thresholds = Thresholds(),
) -> CompareReport:
    """Diff every fresh record against the baseline of the same name."""
    report = CompareReport(thresholds=thr)
    for rec in fresh:
        report.results.append(compare_record(rec, baselines.get(rec.name), thr))
    return report


def append_trajectory(
    point: Dict[str, Any],
    path: Path = DEFAULT_TRAJECTORY,
) -> Path:
    """Append one compare outcome to the trajectory JSONL."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("a") as fh:
        fh.write(json.dumps(point, sort_keys=True) + "\n")
    return path


def read_trajectory(path: Path = DEFAULT_TRAJECTORY) -> List[Dict[str, Any]]:
    path = Path(path)
    if not path.exists():
        return []
    lines = path.read_text().splitlines()
    return [json.loads(ln) for ln in lines if ln.strip()]
