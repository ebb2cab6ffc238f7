"""Host-timed readings of ``chip_smoke.py`` through phase 3, for two
checkouts in turns, and the host's cost of one profiled call.

    python3 host_turns.py OTHER [PAIRS]
    python3 host_turns.py probe

The first form runs ``chip_smoke.py`` of OTHER (another checkout's root,
e.g. a commit unpacked under ``build/`` with ``git archive``) and of this
checkout up to the end of phase 3, each run in a process of its own,
PAIRS pairs (default 4) in the order OTHER, this, this, OTHER, ...; it
prints per run the eager floor call (µs) and phase 3's TTFT p50 and
per-token p50 (s) of both engines, then each reading's medians and the
pairs in which this checkout read lower. Each run's output is kept under
``build/host_turns/``. The second form prints the host's cost of a small
eager step (µs) before and after one profiled SDPA call, and before and
after one question to SDPA's dispatcher, twice each, each in a process of
its own. Both need a CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
READINGS = ("floor_call_us", "continuous_ttft_p50_s", "continuous_tok_p50_s",
            "paged_ttft_p50_s", "paged_tok_p50_s")


class _Stop(Exception):
    pass


def _through_phase3(tree: Path) -> int:
    """``tree``'s ``chip_smoke.main`` up to the end of phase 3."""
    sys.path[:0] = [str(tree), str(tree / "src")]
    sys.argv = [str(tree / "chip_smoke.py")]
    import chip_smoke
    serve = chip_smoke._serve

    def serve_then_stop(dev):
        serve(dev)
        raise _Stop

    chip_smoke._serve = serve_then_stop
    try:
        chip_smoke.main()
    except _Stop:
        return 0
    return 1


def _readings(out: str) -> dict:
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    floor = next(x for x in lines if x.get("phase") == "floor")
    serve = {x["scheduler"]: x for x in lines
             if x.get("phase") == "serve" and "arch" not in x}
    return {"floor_call_us": floor["call_ms"] * 1e3,
            **{f"{e}_{k}": serve[e][k] for e in ("continuous", "paged")
               for k in ("ttft_p50_s", "tok_p50_s")}}


def _turns(other: Path, pairs: int) -> None:
    logs = ROOT / "build" / "host_turns"
    logs.mkdir(parents=True, exist_ok=True)
    sides = {"other": other.resolve(), "this": ROOT}
    runs = []
    for p in range(pairs):
        for side in (("other", "this") if p % 2 == 0 else ("this", "other")):
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "_phase3",
                 str(sides[side])], capture_output=True, text=True)
            (logs / f"run{len(runs) + 1}-{side}.log").write_text(
                proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise SystemExit(f"{side} failed: {proc.stderr[-2000:]}")
            runs.append({"side": side, **_readings(proc.stdout)})
            print(json.dumps(runs[-1]), flush=True)
    for key in READINGS:
        med = {s: statistics.median(r[key] for r in runs if r["side"] == s)
               for s in sides}
        lower = sum(runs[i + (runs[i]["side"] == "other")][key]
                    < runs[i + (runs[i]["side"] == "this")][key]
                    for i in range(0, len(runs), 2))
        print(json.dumps({"reading": key, "median_other": med["other"],
                          "median_this": med["this"],
                          "this_lower_in_pairs": lower, "pairs": pairs}))


def _probe(mode: str) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F

    from repro_torch.core.profile import profile_device
    dev = torch.device("cuda", 0)
    x, w = (torch.randn(64, 64, device=dev) for _ in "xw")

    def host_us(n=4000):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            y = x @ w
            y.add_(1.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    for _ in range(3):
        host_us()
    before = [host_us() for _ in range(5)]
    q = torch.randn(1, 32, 128, 160, device=dev)
    k = torch.randn(1, 8, 128, 160, device=dev)
    if mode == "profile":
        profile_device(lambda: F.scaled_dot_product_attention(
            q, k, k, is_causal=True, enable_gqa=True))
    else:
        torch._fused_sdp_choice(q, k, k, is_causal=True, enable_gqa=True)
    after = [host_us() for _ in range(5)]
    print(json.dumps({"mode": mode, "before_us": before, "after_us": after}))


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["_phase3"]:
        return _through_phase3(Path(args[1]))
    if args[:1] == ["_probe"]:
        _probe(args[1])
        return 0
    if args[:1] == ["probe"]:
        for mode in ("choice", "profile", "choice", "profile"):
            out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                  "_probe", mode], capture_output=True,
                                 text=True, check=True).stdout
            print(out.strip(), flush=True)
        return 0
    _turns(Path(args[0]), int(args[1]) if len(args) > 1 else 4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
