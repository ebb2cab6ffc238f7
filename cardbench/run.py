"""Run one cell of ``BENCHMARK.json`` once on the card this process sees:

    python cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It makes the weights and inputs from ``--seed``, warms up the cell's
shapes (set-up), measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON line. Without a
CUDA card, or with fewer cards than the cell asks for, it exits with code
2 and prints no result; it never falls back to the CPU.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def fixed_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    the kernel library itself lands in ``build/`` (the program's
    ``kernels/_build.py``). Libraries that would load JAX on their own are
    kept from it."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_caches(ROOT)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from cardbench import harness
    cell = harness.load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cardbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"this machine has {n}; no result", file=sys.stderr)
        return 2
    from cardbench import peaks
    print(f"cardbench: card {peaks.power_limit()}", file=sys.stderr)
    line, notes = harness.run(cell, args.seed, args.seconds, args.trace,
                       torch.device("cuda", 0), T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"cardbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    harness.report(line, notes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
