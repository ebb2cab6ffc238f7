"""Repo-seam AST lint: rule-based checks over ``src/repro_torch``, the
port of ``repro/analysis/seams.py``.

The serving and kernel layers keep their invariants behind narrow seams
— every page free goes through ``PagedEngine._release_pages``, every
admission decision through ``admission_error``, runtime invariants raise
real exceptions (bare ``assert`` dies under ``python -O``), and
Sim-clock code never reads the wall clock. This module makes them
mechanical.

Rules (catalog in :data:`repro_torch.analysis.findings.RULES`):

* **RS101** — a bare ``assert`` statement anywhere in the scanned tree.
  Runtime invariants must ``raise`` so they survive ``python -O``.
* **RS102** — an attribute call ``*.free(...)`` outside
  ``_release_pages`` / the ``PageAllocator`` class itself. Going around
  the seam breaks leak accounting and chaos parity.
* **RS103** — an ``*Engine`` class whose ``run`` never calls
  ``self._validate(...)`` (directly or via the extracted
  ``Scheduler.validate`` seam), or whose ``admission_error`` override
  never defers to ``super().admission_error(...)``.
* **RS104** — ``time.time/perf_counter/monotonic/sleep`` calls in
  serving-scoped modules (under ``serving/``, or importing the serving
  layer, ``repro_torch.serving`` or the reference's ``repro.serving``)
  outside a ``*Clock`` class. Sim-clock runs must stay deterministic.
* **RS105** — ``np.``/``numpy.`` usage inside a function that the same
  module passes to ``torch.compile``, ``torch.jit.script`` or
  ``torch.cuda.make_graphed_callables`` (the port's counterpart of the
  reference's ``jax.jit``): a host round-trip that breaks the graph or
  is frozen into it. The port calls none of them today.

Findings are pragma-suppressible per line (``# repro: allow=RSxxx``).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Sequence

from .findings import REPO, Finding, apply_pragmas, relpath

_TIME_FUNCS = {"time", "perf_counter", "monotonic", "sleep", "process_time"}
_NUMPY_ALIASES = {"np", "numpy", "onp"}
# the calls that compile or graph a function: what jax.jit is to the
# reference
_JIT_NAMES = ("torch.compile", "torch.jit.script",
              "torch.cuda.make_graphed_callables")
# the serving layer of the port, and of the reference (whose fixtures the
# port's tests lint)
_SERVING_MODULES = ("repro_torch.serving", "repro.serving")


def _call_name(node: ast.AST) -> Optional[str]:
    """Dotted name of a call target (``a.b.c`` -> "a.b.c") or None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_serving_scoped(path: Path, tree: ast.Module) -> bool:
    """Modules bound by the Sim-clock discipline: anything under
    ``serving/`` plus any module importing the serving request layer."""
    if "serving" in Path(path).parts:
        return True
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.startswith(_SERVING_MODULES) or mod == "serving.request":
                return True
        elif isinstance(node, ast.Import):
            if any(a.name.startswith(_SERVING_MODULES) for a in node.names):
                return True
    return False


def _jitted_local_functions(tree: ast.Module) -> set:
    """Names of module-local defs passed to a compiling call anywhere in
    the module (covers ``torch.compile(fn)``, ``torch.jit.script(fn)``,
    ``torch.cuda.make_graphed_callables(fn, ...)`` or a tuple of
    callables there, and ``@torch.compile`` / ``@torch.compile(...)`` /
    ``@partial(torch.compile, ...)`` decorators)."""
    jitted: set = set()

    def _mark(arg: ast.AST) -> None:
        if isinstance(arg, ast.Name):
            jitted.add(arg.id)
        elif isinstance(arg, (ast.Tuple, ast.List)):
            for elt in arg.elts:
                _mark(elt)

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = _call_name(node.func)
            if name in _JIT_NAMES:
                for arg in node.args[:1]:
                    _mark(arg)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                dname = _call_name(dec if not isinstance(dec, ast.Call) else dec.func)
                if dname in _JIT_NAMES:
                    jitted.add(node.name)
                elif (
                    isinstance(dec, ast.Call)
                    and dname in ("partial", "functools.partial")
                    and dec.args
                    and _call_name(dec.args[0]) in _JIT_NAMES
                ):
                    jitted.add(node.name)
    return jitted


class _SeamVisitor(ast.NodeVisitor):
    def __init__(self, path: str, serving_scoped: bool, jitted: set):
        self.path = path
        self.serving_scoped = serving_scoped
        self.jitted = jitted
        self.findings: List[Finding] = []
        self._class_stack: List[str] = []
        self._func_stack: List[str] = []

    # -- stack bookkeeping -------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        if node.name.endswith("Engine"):
            self._check_engine(node)
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_func(self, node) -> None:
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- RS101: bare assert ------------------------------------------------
    def visit_Assert(self, node: ast.Assert) -> None:
        self.findings.append(
            Finding(
                "RS101",
                self.path,
                node.lineno,
                "bare assert guards a runtime invariant; raise an exception "
                "instead (asserts vanish under python -O)",
            )
        )
        self.generic_visit(node)

    # -- RS102 / RS104 / RS105: call-site rules ----------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node.func)
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "free"
            and "_release_pages" not in self._func_stack
            and "PageAllocator" not in self._class_stack
        ):
            self.findings.append(
                Finding(
                    "RS102",
                    self.path,
                    node.lineno,
                    f"direct page free `{name or 'free'}(...)` outside "
                    "PagedEngine._release_pages bypasses leak accounting",
                )
            )
        if (
            self.serving_scoped
            and name is not None
            and name.startswith("time.")
            and name.split(".", 1)[1] in _TIME_FUNCS
            and not any(c.endswith("Clock") for c in self._class_stack)
        ):
            self.findings.append(
                Finding(
                    "RS104",
                    self.path,
                    node.lineno,
                    f"wall-clock call `{name}()` in a Sim-clock code path; "
                    "route timing through the engine's Clock",
                )
            )
        if (
            name is not None
            and name.split(".", 1)[0] in _NUMPY_ALIASES
            and self._func_stack
            and any(f in self.jitted for f in self._func_stack)
        ):
            self.findings.append(
                Finding(
                    "RS105",
                    self.path,
                    node.lineno,
                    f"numpy host op `{name}(...)` inside compiled function "
                    f"`{self._func_stack[-1]}`; use torch ops or hoist it out",
                )
            )
        self.generic_visit(node)

    # -- RS103: engine admission seam --------------------------------------
    def _check_engine(self, cls: ast.ClassDef) -> None:
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if item.name == "run":
                if (
                    self._body_is_stub(item)
                    or self._calls(item, "self._validate")
                    or self._calls_suffix(item, ".validate")
                ):
                    continue
                self.findings.append(
                    Finding(
                        "RS103",
                        self.path,
                        item.lineno,
                        f"{cls.name}.run never calls self._validate(...) or "
                        "the Scheduler.validate seam; requests enter the "
                        "pool without admission checks",
                    )
                )
            elif item.name == "admission_error" and cls.bases:
                if self._calls(item, "super"):
                    continue
                self.findings.append(
                    Finding(
                        "RS103",
                        self.path,
                        item.lineno,
                        f"{cls.name}.admission_error override never defers to "
                        "super().admission_error(...); base checks are lost",
                    )
                )

    @staticmethod
    def _body_is_stub(fn) -> bool:
        body = [
            n
            for n in fn.body
            if not (isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant))
        ]
        return all(isinstance(n, (ast.Raise, ast.Pass)) for n in body)

    @staticmethod
    def _calls(fn, prefix: str) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = _call_name(node.func)
                if name is not None and name.startswith(prefix):
                    return True
        return False

    @staticmethod
    def _calls_suffix(fn, suffix: str) -> bool:
        """Any call whose dotted target ends with ``suffix`` — how the
        role-composed engines reach admission checks through an
        extracted ``Scheduler`` (``sched.validate(requests)``)."""
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = _call_name(node.func)
                if name is not None and name.endswith(suffix):
                    return True
        return False


def scan_source(
    source: str, path: str = "<string>", *, serving_scoped: Optional[bool] = None
) -> List[Finding]:
    """Lint one module's source; returns pragma-filtered findings."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("RS101", path, e.lineno or 0, f"unparseable module: {e.msg}")]
    scoped = (
        serving_scoped
        if serving_scoped is not None
        else _is_serving_scoped(Path(path), tree)
    )
    visitor = _SeamVisitor(path, scoped, _jitted_local_functions(tree))
    visitor.visit(tree)
    return apply_pragmas(visitor.findings, source.splitlines())


def scan_file(path: Path) -> List[Finding]:
    try:
        source = Path(path).read_text()
    except (OSError, UnicodeDecodeError):
        return []
    return scan_source(source, relpath(path))


def scan_tree(root: Optional[Path] = None) -> List[Finding]:
    """Lint every ``.py`` file under ``root`` (default
    ``src/repro_torch``)."""
    root = Path(root) if root is not None else REPO / "src" / "repro_torch"
    findings: List[Finding] = []
    for path in sorted(root.rglob("*.py")):
        findings.extend(scan_file(path))
    return findings


def scan_paths(paths: Sequence[Path]) -> List[Finding]:
    findings: List[Finding] = []
    for p in paths:
        p = Path(p)
        findings.extend(scan_tree(p) if p.is_dir() else scan_file(p))
    return findings
