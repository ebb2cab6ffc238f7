"""CLI for the port's static analysis.

``python -m repro_torch.analysis`` runs all three layers over the repo
and exits 0 when clean, 1 when any finding survives, 2 on an internal
error. ``--layer`` selects a subset (``seams`` is pure AST and runs in
milliseconds; ``kernels`` is arithmetic only; ``graphs`` runs the tiny
step functions, on the card where there is one, and takes seconds).
``--json`` emits JSON lines — one finding per line with rule id, file,
line, and message; ``--list-rules`` prints the catalog. The reference's
``--backend`` has no counterpart: there is one card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List

from .findings import RULES, Finding, render, summarize

LAYERS = ("seams", "kernels", "graphs")


def run_layers(layers, *, root=None, steady_state: bool = True
               ) -> List[Finding]:
    findings: List[Finding] = []
    if "seams" in layers:
        from . import seams

        findings += seams.scan_tree(Path(root) if root else None)
    if "kernels" in layers:
        from . import kernel_lint

        findings += kernel_lint.check_all()
    if "graphs" in layers:
        from . import graph_audit

        findings += graph_audit.audit_all(include_steady_state=steady_state)
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="launch-contract, step-purity and seam static analysis",
    )
    ap.add_argument(
        "--layer",
        action="append",
        choices=LAYERS,
        help="run only this layer (repeatable; default: all)",
    )
    ap.add_argument(
        "--root", default=None,
        help="tree for the seam lint (default: src/repro_torch)"
    )
    ap.add_argument(
        "--no-steady-state",
        action="store_true",
        help="skip the engine double-run audit (the slowest graph check)",
    )
    ap.add_argument("--json", action="store_true", help="emit findings as JSON lines")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    layers = tuple(args.layer) if args.layer else LAYERS
    try:
        findings = run_layers(
            layers, root=args.root, steady_state=not args.no_steady_state
        )
    except Exception as e:  # internal error, not a finding
        print(f"analysis error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    render(findings, as_json=args.json)
    print(
        f"repro_torch.analysis [{','.join(layers)}]: {summarize(findings)}",
        file=sys.stderr,
    )
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
