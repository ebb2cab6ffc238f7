"""Readings that set a cell's correctness limits, and the knee of a serving
mix, on the card. The benchmark's own runs never run this.

    python cardbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds S] [--rates r1,r2,...]

A training cell: for each seed the program's readings over the mix's
first steps against the reference's (the sound readings); for each control
seed also the reference in TF32 (the control) and the reference with half
of each batch left out (a planted fault) against it. A step that returns
its state unchanged reads 1 on ``grad`` and ``change`` by their
definition and needs no run.

A serving cell: for each seed one window of ``--seconds`` at the mix's
rate, through the driver's own set-up, window and check
(``drivers/serve.py``), and its numbers (sound); for each control seed also
the control's: the reference in TF32 in the program's place. ``--rates``
instead sweeps the offered rate, one window a rate and seed, for the knee:
the highest rate whose backlog does not grow through the window.

One JSON line a reading on standard output.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def _free(device) -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train(cell, seeds, controls, device) -> None:
    from cardbench import compare
    from cardbench.drivers import train as drv
    c, t = cell.config, cell.traffic
    for seed in seeds:
        t0 = time.perf_counter()
        prog, readings = drv.program_setup(c, t, seed, device)
        del prog
        _free(device)
        ref = drv.reference_readings(c, t, seed, device)
        line = {"seed": seed, "sound": compare.train_numbers(readings, ref),
                "losses": readings["losses"], "ref_losses": ref["losses"],
                "worst_grad": compare.worst_leaves(readings["grad"],
                                                   ref["grad"]),
                "worst_change": compare.worst_leaves(readings["change"],
                                                     ref["change"])}
        if seed in controls:
            ctl = drv.reference_readings(c, t, seed, device,
                                         precision="tf32")
            line["control_tf32"] = compare.train_numbers(ctl, ref)
            half = drv.reference_readings(c, t, seed, device,
                                          rows_kept=t["rows"] // 2)
            line["half_batch"] = compare.train_numbers(half, ref)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        _free(device)


def knee(report, seconds: float) -> dict:
    """Whether the backlog grew through a window: the mean queue wait of
    the requests due in its first and last thirds, and how long the
    engine ran past the window's close."""
    ok = [m for m in report.metrics if m.outcome == "completed"]
    third = seconds / 3

    def wait(lo, hi):
        w = [m.admitted_s - m.arrival_s for m in ok
             if lo <= m.arrival_s < hi]
        return 1e3 * statistics.fmean(w) if w else None

    return {"requests": len(report.metrics), "completed": len(ok),
            "queue_mean_first_third_ms": wait(0, third),
            "queue_mean_last_third_ms": wait(2 * third, seconds),
            "drain_s": report.makespan_s - seconds}


def serve(cell, seeds, controls, seconds, rates, device) -> None:
    """One engine a seed. With ``rates``, one window at each rate (the
    knee's sweep); else one window at the mix's rate and the check's
    numbers, and for a control seed the control's."""
    from cardbench import traffic as tr
    from cardbench.drivers import serve as drv
    c = cell.config
    for seed in seeds:
        srv, t, _ = drv.setup(cell, seed, device)
        for rate in rates or [t["rate_per_s"]]:
            mix = {**t, "rate_per_s": rate}
            arrivals = tr.open_loop(seed, seconds, mix, c["vocab_size"])
            report, watch = drv.window(srv, arrivals, seed, mix)
            line = {"seed": seed, "rate_per_s": rate, "seconds": seconds,
                    **drv.latencies(report.metrics), **knee(report, seconds)}
            if rates:
                print(json.dumps(line), flush=True)
        del srv
        if rates:
            _free(device)
            continue
        served = watch.served(report)
        del report, watch
        _free(device)
        line["rows"] = sum(len(r) for _, _, r, _ in served)
        nums = drv.check_numbers(c, served, seed, device,
                                 control=seed in controls)
        line.update(nums if seed in controls else {"sound": nums})
        print(json.dumps(line), flush=True)
        _free(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", default="")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    from cardbench import harness
    from cardbench.run import fixed_caches
    fixed_caches(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    device = torch.device("cuda", 0)
    if cell.traffic["kind"] == "train":
        train(cell, args.seeds, set(args.control_seeds), device)
    else:
        serve(cell, args.seeds, set(args.control_seeds), args.seconds,
              [float(r) for r in args.rates.split(",") if r], device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
