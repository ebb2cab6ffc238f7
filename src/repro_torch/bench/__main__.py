"""The port's benchmark harness on the card, the counterpart of
``python -m benchmarks.run``:

    PYTHONPATH=src python -m repro_torch.bench [--only <name-or-substr>[,..]]
                                               [--tags tag1,tag2] [--tune]
                                               [--device cuda|cpu]
                                               [--compare [--bless]]
                                               [--compare-only]
                                               [--json <path> | --no-json]
                                               [--list]

Prints ``name,us_per_call,derived`` CSV (one line per measurement) on
stdout and writes BenchRecord JSONL (default
``results/bench_torch/latest.jsonl``). Exits non-zero if any scenario
workload raises. ``--only`` takes a comma-separated list; a term that
exactly names a registered scenario selects just that scenario, anything
else is a substring filter over names and groups.

``--tune`` runs the launch-parameter sweeps (scenarios tagged ``tune``,
left out of every other run; alone it selects only them), whose winners
persist to ``results/tuned/cuda.json`` (:mod:`repro_torch.kernels.tuning`).

It runs on the card: without one it raises unless ``--device cpu``
asks for the CPU, where the measured suites run the kernels' plain
versions (their times are the CPU's, and their records say so in
``env.backend`` and the ``device`` knob). It never falls back.

``--compare`` diffs the records against the blessed baselines under
``results/baselines_torch/`` (p50 ratio + a sign test over per-iteration
samples, :mod:`repro_torch.bench.compare`), appends a point to
``results/trajectory_torch.jsonl``, and exits 3 on regression.
``--bless`` accepts the fresh records as the new baselines.
``--compare-only`` compares the existing ``--json`` file without running.

| suite                 | scenario groups | paper artifact            |
|-----------------------|-----------------|---------------------------|
| suites.allocation     | allocation      | Table I / Fig. 6-7        |
| suites.load_balance   | load_balance    | Fig. 8 (LI, Eq. 3/4)      |
| suites.efficiency     | efficiency      | Fig. 9 (measured)         |
| suites.roofline       | roofline        | Fig. 10 (measured step)   |
| suites.serving        | serving         | Tier-2 (serving, 9 scen.) |
| suites.batch_precision| deploy          | Fig. 12 / Table IV        |
| suites.kernels        | kernels         | kernel micro-benchmarks   |
| suites.scalability    | scalability     | Fig. 11 / Table III       |
| suites.tune           | tune (--tune)   | guidance for perf opts    |
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
DEFAULT_JSONL = REPO / "results" / "bench_torch" / "latest.jsonl"


def with_device(scen, device: str):
    """``scen`` with the ``device`` knob on each workload of its measured
    suites (the structural ones run no model)."""
    if "measured" not in scen.tags:
        return scen
    return dataclasses.replace(scen, workloads=tuple(
        dataclasses.replace(wl, knobs={**wl.knobs, "device": device})
        for wl in scen.workloads))


def run_compare(records, baseline_dir: str, trajectory: str,
                do_bless: bool) -> bool:
    """Diff ``records`` against the blessed baselines of their backend;
    append a trajectory point; optionally bless. True when the gate
    passes (no regression, or --bless accepted the new numbers). The
    report goes to stderr; stdout stays the CSV stream."""
    from repro_torch.bench import (append_trajectory, bless, compare_records,
                                   load_baselines)
    from repro_torch.bench.baseline import record_backend
    from repro_torch.bench.compare import CompareReport

    bdir = Path(baseline_dir)
    by_backend = {}
    for rec in records:
        by_backend.setdefault(record_backend(rec), []).append(rec)
    report = CompareReport()
    any_baselines = False
    for backend in sorted(by_backend):
        baselines = load_baselines(bdir, backend)
        any_baselines = any_baselines or bool(baselines)
        report.results.extend(
            compare_records(by_backend[backend], baselines).results)
    skipped = len(report.by_status("skipped"))
    if any_baselines and skipped and not report.trajectory_point()["compared"]:
        print("WARNING: 0 comparable record pairs — baselines exist but "
              f"{skipped} pairs were skipped (env fingerprint mismatch?); "
              "the regression gate was a no-op this run", file=sys.stderr)
    print("", file=sys.stderr)
    for line in report.lines():
        print(line, file=sys.stderr)
    append_trajectory(report.trajectory_point(extra={"blessed": do_bless}),
                      Path(trajectory))
    if do_bless:
        for backend, path in bless(records, bdir).items():
            print(f"blessed baselines [{backend}] -> {path}",
                  file=sys.stderr)
        return True
    if not report.ok:
        names = ", ".join(r.name for r in report.regressions)
        print(f"PERFORMANCE REGRESSION: {names}\n"
              f"(re-bless intended slowdowns with --compare --bless)",
              file=sys.stderr)
    return report.ok


def main(argv: list[str] | None = None) -> int:
    from repro_torch.bench import (BenchRunner, CsvStdoutSink, JsonlSink,
                                   env_fingerprint, read_jsonl, select)
    from repro_torch.bench.baseline import baseline_dir

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated scenario filter: exact scenario "
                         "name > substring on scenario/group name")
    ap.add_argument("--tags", default=None,
                    help="comma-separated tag filter (any-of)")
    ap.add_argument("--tune", action="store_true",
                    help="run the launch-parameter sweeps (scenarios "
                         "tagged `tune`, left out of other runs); winners "
                         "persist to results/tuned/cuda.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the measured suites run (default: the "
                         "card; without one the harness raises)")
    ap.add_argument("--compare", action="store_true",
                    help="diff resulting records against blessed "
                         "baselines; exit 3 on regression")
    ap.add_argument("--compare-only", action="store_true",
                    help="skip running scenarios; compare the existing "
                         "--json records against baselines")
    ap.add_argument("--bless", action="store_true",
                    help="with --compare/--compare-only: accept the "
                         "fresh records as the new blessed baselines")
    ap.add_argument("--baseline-dir", metavar="DIR",
                    default=str(REPO / baseline_dir()),
                    help="blessed-baseline directory (default: "
                         "results/baselines_torch; env "
                         "REPRO_TORCH_BASELINE_DIR overrides)")
    ap.add_argument("--trajectory", metavar="PATH",
                    default=str(REPO / "results" / "trajectory_torch.jsonl"),
                    help="trajectory JSONL appended on every compare")
    ap.add_argument("--json", default=str(DEFAULT_JSONL), metavar="PATH",
                    help=f"BenchRecord JSONL output path (default: "
                         f"{DEFAULT_JSONL})")
    ap.add_argument("--no-json", action="store_true",
                    help="skip the JSONL sink")
    ap.add_argument("--list", action="store_true",
                    help="list matching scenarios and exit")
    args = ap.parse_args(argv)
    tags = [t for t in (args.tags or "").split(",") if t] or None

    if args.compare_only:
        if not Path(args.json).exists():
            print(f"--compare-only: no records at {args.json}",
                  file=sys.stderr)
            return 2
        ok = run_compare(read_jsonl(args.json), args.baseline_dir,
                         args.trajectory, args.bless)
        return 0 if ok else 3

    import repro_torch.bench.suites  # noqa: F401  (registers the scenarios)
    from repro_torch.models.model import resolve_device

    resolve_device(args.device)     # raises without a card: no fallback
    selected = [with_device(s, args.device)
                for s in select(only=args.only, tags=tags)]
    # the sweeps are opt-in: left out unless --tune; a bare --tune (no
    # other filter) runs only them
    if not args.tune:
        selected = [s for s in selected if "tune" not in s.tags]
    elif not args.only and not tags:
        selected = [s for s in selected if "tune" in s.tags]
    if args.list:
        for scen in selected:
            print(f"{scen.name:32s} tags={','.join(scen.tags):40s} "
                  f"[{scen.paper_ref}]")
        return 0
    if not selected:
        print("no scenarios matched", file=sys.stderr)
        return 1

    sinks = [CsvStdoutSink()]
    if not args.no_json:
        try:
            jsonl = JsonlSink(args.json)
        except OSError as e:
            print(f"cannot write --json {args.json}: {e}", file=sys.stderr)
            return 2
        # a filtered run into an existing result set carries over the
        # records of scenarios outside the filter
        if args.only or tags:
            names = {s.name for s in selected}
            prior = read_jsonl(args.json) if Path(args.json).exists() else []
            for rec in prior:
                if rec.scenario not in names:
                    jsonl.emit(rec)
        sinks.append(jsonl)
    summary = BenchRunner(sinks=sinks,
                          env=env_fingerprint(args.device)).run(selected)
    if summary.failures:
        print(f"\n{len(summary.failures)} failure(s):", file=sys.stderr)
        for name, err in summary.failures:
            print(f"  {name}: {err}", file=sys.stderr)
        return 1
    if args.compare or args.bless:
        records = read_jsonl(args.json) if not args.no_json \
            else summary.records
        if not run_compare(records, args.baseline_dir, args.trajectory,
                           args.bless):
            return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
