"""Finding records shared by every static-analysis layer of the port (a
copy of ``repro/analysis/findings.py``; the port imports nothing of the
JAX package).

A :class:`Finding` is one machine-readable violation: rule id, rule
name, ``file:line`` location, and a message naming the offender. The CLI
(:mod:`repro_torch.analysis.__main__`) prints findings either
human-readable or as JSON lines (one object per finding), and exits
non-zero when any survive.

Suppression is per-line and explicit: a ``# repro: allow=<RULE>`` pragma
on the offending line (or the line directly above it) silences that rule
there, and ``# repro: allow=*`` silences every rule. The rule IDs are the
reference's; the kernel (RK) and step-audit (RG) rules say what they
check on Hopper.
"""

from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

REPO = Path(__file__).resolve().parents[3]

# rule id -> one-line description; every layer registers its rules here
# so the CLI's --list-rules stays in one place
RULES = {
    # launch-contract lint (repro_torch.analysis.kernel_lint)
    "RK001": "kernel grid must cover every row, key tile, page and V "
             "column of its operands once",
    "RK002": "dynamic + static shared memory must fit the card's opt-in "
             "limit (and a cluster must fit an SM group)",
    "RK003": "kernel dims must be ones the kernel is built for (head dim, "
             "VEC multiple, K and V at most 64)",
    "RK004": "launch must respect the card's limits: threads in whole warps "
             "up to the block limit, grid y/z, cluster size dividing grid x",
    "RK005": "kernel operand dtype must be float32 or bfloat16",
    # step dispatch audit (repro_torch.analysis.graph_audit)
    "RG001": "no host reads (_local_scalar_dense) inside a step",
    "RG002": "no f64/c128 values inside a step",
    "RG003": "steady-state engine runs must build, load and launch nothing "
             "new",
    "RG004": "single-device steps must not issue c10d collectives",
    "RG005": "steps must not copy between host and device",
    # repo-seam AST lint (repro_torch.analysis.seams)
    "RS101": "runtime invariants must raise, not bare-assert",
    "RS102": "page frees only through PagedEngine._release_pages",
    "RS103": "engine admission must route through admission_error "
             "(self._validate or the Scheduler.validate seam)",
    "RS104": "no wall-clock time.* calls in Sim-clock code paths",
    "RS105": "no numpy host ops inside compiled or graphed step functions",
}

_PRAGMA_RE = re.compile(r"#\s*repro:\s*allow=([A-Z*][A-Z0-9*]*)")


@dataclass
class Finding:
    """One violation: where it is, which rule, and what it says."""

    rule: str  # e.g. "RS101"
    path: str  # repo-relative (or synthetic) source
    line: int  # 1-indexed; 0 = whole-target finding
    message: str

    @property
    def name(self) -> str:
        return RULES.get(self.rule, "unknown-rule")

    def to_json(self) -> str:
        d = asdict(self)
        d["name"] = self.name
        return json.dumps(d, sort_keys=True)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def relpath(path: Path) -> str:
    """Repo-relative display path (absolute when outside the repo)."""
    try:
        return str(Path(path).resolve().relative_to(REPO))
    except ValueError:
        return str(path)


def suppressed(source_lines: Sequence[str], line: int, rule: str) -> bool:
    """Whether ``rule`` is pragma-silenced at 1-indexed ``line`` (pragma
    on the line itself or the one above)."""
    for ln in (line, line - 1):
        if 1 <= ln <= len(source_lines):
            for m in _PRAGMA_RE.finditer(source_lines[ln - 1]):
                if m.group(1) in (rule, "*"):
                    return True
    return False


def apply_pragmas(
    findings: Iterable[Finding], source_lines: Sequence[str]
) -> List[Finding]:
    """Drop findings whose location carries an allow pragma."""
    return [f for f in findings if not suppressed(source_lines, f.line, f.rule)]


def render(findings: Sequence[Finding], *, as_json: bool = False, out=None) -> None:
    """Print findings (JSONL or human) to ``out`` (default stdout)."""
    import sys

    out = out or sys.stdout
    for f in findings:
        print(f.to_json() if as_json else str(f), file=out)


def summarize(findings: Sequence[Finding]) -> str:
    by_rule: dict = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    parts = " ".join(f"{r}={n}" for r, n in sorted(by_rule.items()))
    return f"{len(findings)} finding(s) [{parts}]" if findings else "clean"


def load_source(path: Path) -> Optional[str]:
    try:
        return Path(path).read_text()
    except (OSError, UnicodeDecodeError):
        return None
