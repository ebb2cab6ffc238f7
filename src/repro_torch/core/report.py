"""Rendering helpers: turn the port's BenchRecord JSONL and Tier-1 reports
into markdown tables, as ``repro/core/report.py`` does for the JAX
package. Derived metrics are read from each record's dict, never parsed
from strings."""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional

from repro_torch.bench.record import BenchRecord, read_jsonl


def md_table(headers: List[str], rows: Iterable[Iterable]) -> str:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    for r in rows:
        out.append("| " + " | ".join(str(x) for x in r) + " |")
    return "\n".join(out)


def fmt_s(x: Optional[float]) -> str:
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


# ----------------------------------------------------- BenchRecord tables
def load_bench_records(path: str | Path) -> List[BenchRecord]:
    """Load harness results; [] if absent."""
    path = Path(path)
    return read_jsonl(path) if path.exists() else []


def group_records(recs: Iterable[BenchRecord]
                  ) -> Dict[str, List[BenchRecord]]:
    """Bucket records by scenario family, preserving record order."""
    out: Dict[str, List[BenchRecord]] = {}
    for r in recs:
        out.setdefault(r.group or r.name.split("/", 1)[0], []).append(r)
    return out


def derived_keys(recs: Iterable[BenchRecord]) -> List[str]:
    """Union of derived-metric names, in first-seen order."""
    keys: List[str] = []
    for r in recs:
        for k in r.derived:
            if k not in keys:
                keys.append(k)
    return keys


def _fmt_cell(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def bench_table(recs: List[BenchRecord],
                columns: Optional[List[str]] = None) -> str:
    """Markdown table straight from BenchRecords: one row per record,
    one column per derived metric (``columns`` narrows/orders them)."""
    cols = columns if columns is not None else derived_keys(recs)
    headers = ["name", "us/call"] + cols
    rows = []
    for r in recs:
        row = [r.name if r.status == "ok" else f"{r.name} (!)",
               f"{r.us_per_call:.1f}" if r.us_per_call else "-"]
        row += [_fmt_cell(r.derived.get(k)) for k in cols]
        rows.append(row)
    return md_table(headers, rows)


def bench_summary(recs: List[BenchRecord]) -> str:
    """One markdown section per scenario group."""
    parts = []
    for group, rows in group_records(recs).items():
        ref = next((r.paper_ref for r in rows if r.paper_ref), "")
        title = f"### {group}" + (f" — {ref}" if ref else "")
        parts.append(f"{title}\n\n{bench_table(rows)}")
    return "\n\n".join(parts)


def roofline_table(reports: list) -> str:
    """One row per Tier-1 report (``Tier1Report.to_dict()``): the roofline
    terms of its counted step, its MFU at the roofline and at the
    measured step, and the useful share of the counted FLOPs."""
    headers = ["arch", "shape", "mesh", "compute", "memory", "collective",
               "dominant", "MFU", "MFU measured", "useful", "step"]
    rows = []
    for r in reports:
        rl = r.get("roofline") or {}
        m = r.get("measured", {})
        rows.append([
            r["arch"], r["shape"], r["mesh"],
            fmt_s(rl.get("compute_s")), fmt_s(rl.get("memory_s")),
            fmt_s(rl.get("collective_s")), rl.get("dominant", "-"),
            f"{rl.get('mfu') or 0:.3f}",
            f"{m.get('mfu_measured') or 0:.3f}",
            f"{rl.get('useful_flops_ratio') or 0:.2f}",
            fmt_s(m.get("step_s")),
        ])
    return md_table(headers, rows)
