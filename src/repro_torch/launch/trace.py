"""Trace CLI of the port: capture a step trace, replay it, ask what-if
questions. The counterpart of ``repro/launch/trace.py``.

    PYTHONPATH=src python -m repro_torch.launch.trace capture \
        --arch granite-3-8b --split 1x1 --out results/traces_torch/t.json
    PYTHONPATH=src python -m repro_torch.launch.trace capture \
        --split 2x4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.trace replay t.json \
        [--scale-op aten.mm=0.5] [--scale-kind collective=2.0]
    PYTHONPATH=src python -m repro_torch.launch.trace whatif t.json --split 2x4
    PYTHONPATH=src python -m repro_torch.launch.trace advise t.json --devices 8

``capture`` runs the real (reduced) train step at the requested (data,
model) split and writes the trace JSON. It runs on the card unless
``--device cpu`` is given: a split of one rank in this process, a wider
one on as many ranks started for it (one card a rank on the card, gloo
ranks on the CPU). A split wider than the machine's cards raises, naming
the cards it needs. The other three subcommands never run the model: they
load a trace (the port's or the reference's: the layout is the same) and
work on its DAG, printing one JSON object to stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _parse_split(text: str):
    try:
        dp, tp = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"bad --split {text!r}: expected DPxTP like 2x4")
    return dp, tp


def _parse_edit(text: str, what: str):
    if "=" not in text:
        raise SystemExit(f"bad --scale-{what} {text!r}: expected NAME=FACTOR")
    name, factor = text.split("=", 1)
    return name, float(factor)


def cmd_capture(args) -> int:
    import torch

    from repro_torch.models.model import resolve_device
    from repro_torch.trace import capture_matrix_cell, capture_train_trace

    split = _parse_split(args.split)
    n = split[0] * split[1]
    device = resolve_device(args.device)
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(
            f"split {args.split} needs {n} cards; this machine has "
            f"{torch.cuda.device_count()} (--device cpu runs it on gloo "
            "ranks)")
    if n == 1:
        trace = capture_train_trace(
            args.arch, split=split, batch=args.batch, seq=args.seq,
            iters=args.iters, device=device.type)
    else:
        trace = capture_matrix_cell(
            n, [split], arch=args.arch, batch=args.batch, seq=args.seq,
            iters=args.iters, device=device.type)[0]
    out = Path(args.out)
    trace.save(out)
    print(json.dumps({
        "trace": str(out),
        "name": trace.name,
        "events": len(trace.events),
        "measured_us": round(trace.measured_step_s * 1e6, 1),
        "lanes_us": {k: round(v * 1e6, 1)
                     for k, v in trace.lane_seconds().items()},
    }, indent=2))
    return 0


def cmd_replay(args) -> int:
    from repro_torch.trace import load_trace, replay, scale_kind, scale_op

    trace = load_trace(args.trace)
    edits = []
    for spec in args.scale_op or ():
        edits.append(scale_op(*_parse_edit(spec, "op")))
    for spec in args.scale_kind or ():
        edits.append(scale_kind(*_parse_edit(spec, "kind")))
    res = replay(trace, edits=edits)
    measured_us = trace.measured_step_s * 1e6
    out = {
        "trace": trace.name,
        "predicted_us": round(res.predicted_s * 1e6, 1),
        "measured_us": round(measured_us, 1),
        "dominant": res.dominant_lane,
        "critical_path": res.critical_path,
        "edits": len(edits),
    }
    if measured_us > 0 and not edits:
        out["identity_rel_err"] = round(
            abs(res.predicted_s * 1e6 - measured_us) / measured_us, 6)
    print(json.dumps(out, indent=2))
    return 0


def cmd_whatif(args) -> int:
    from repro_torch.trace import load_trace, predict_split

    trace = load_trace(args.trace)
    split = _parse_split(args.split)
    res = predict_split(trace, split)
    print(json.dumps({
        "trace": trace.name,
        "split": f"{split[0]}x{split[1]}",
        "predicted_us": round(res.predicted_s * 1e6, 1),
        "dominant": res.dominant_lane,
        "lanes_us": {eid: round(t * 1e6, 1)
                     for eid, t in res.finish_s.items()
                     if eid not in ("root", "sink")},
    }, indent=2))
    return 0


def cmd_advise(args) -> int:
    from repro_torch.trace import advise_from_trace, load_trace

    trace = load_trace(args.trace)
    ranked = advise_from_trace(trace, args.devices)
    print(json.dumps({
        "trace": trace.name,
        "devices": args.devices,
        "calibration": {k: round(v, 4) if k.endswith("ratio") else round(v, 1)
                        for k, v in trace.calibration().items()},
        "ranking": [{
            "split": "x".join(map(str, a.mesh.shape)),
            "step_us": round(a.step_s * 1e6, 1),
            "dominant": a.dominant,
            "fits": a.fits,
        } for a in ranked],
    }, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.trace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    cap = sub.add_parser("capture", help="capture a train-step trace")
    cap.add_argument("--arch", default="granite-3-8b")
    cap.add_argument("--split", default="1x1", help="DPxTP, e.g. 2x4")
    cap.add_argument("--batch", type=int, default=8)
    cap.add_argument("--seq", type=int, default=64)
    cap.add_argument("--iters", type=int, default=5)
    cap.add_argument("--out", default="results/traces_torch/trace.json")
    cap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                     help="the card (default) or gloo ranks on the CPU")
    cap.set_defaults(fn=cmd_capture)

    rep = sub.add_parser("replay", help="replay a trace, optionally edited")
    rep.add_argument("trace")
    rep.add_argument("--scale-op", action="append", metavar="OP=FACTOR")
    rep.add_argument("--scale-kind", action="append", metavar="KIND=FACTOR")
    rep.set_defaults(fn=cmd_replay)

    wi = sub.add_parser("whatif", help="predict step time at another split")
    wi.add_argument("trace")
    wi.add_argument("--split", required=True, help="DPxTP, e.g. 2x4")
    wi.set_defaults(fn=cmd_whatif)

    adv = sub.add_parser("advise", help="trace-calibrated mesh advisor")
    adv.add_argument("trace")
    adv.add_argument("--devices", type=int, default=8)
    adv.set_defaults(fn=cmd_advise)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
