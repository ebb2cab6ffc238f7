"""What the benchmark imports: nothing of JAX or of the JAX package
anywhere (top-level names compared whole: ``repro_torch`` begins with
``repro``), the program only through ``program.py``, and the plain
reference nothing of the program at all."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BASE = Path(__file__).resolve().parent
FILES = sorted(p for p in BASE.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BASE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = sorted(m for m in _imports(path) if m.split(".")[0] in FORBIDDEN)
    assert not bad, bad


def test_only_the_program_adapter_and_the_tests_import_the_program():
    users = {str(p.relative_to(BASE)) for p in FILES
             if any(m.split(".")[0] == "repro_torch" for m in _imports(p))}
    assert users <= {"program.py", "test_cardbench_counts.py",
                     "test_cardbench_run.py"}, users


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BASE / "reference").glob("*.py")):
        mods = _imports(path)
        assert not {m for m in mods if m.split(".")[0] == "repro_torch"}
        assert all(m.startswith("cardbench.reference") for m in mods
                   if m.startswith("cardbench")), (path.name, mods)
        assert "cardbench.program" not in mods
