"""The port stands alone: ``src/repro_torch``, ``chip_smoke.py`` and
``ab_attention.py`` import nothing of JAX or of the JAX package, and the
port's entry points run on the card by default, never falling back to the
CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jax  # noqa: F401  (the test files import both packages)

from repro_torch.launch.serve import build_engine

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "ab_attention.py", REPO / "host_turns.py"]


def _imported_modules(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = sorted(m for m in _imported_modules(path)
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_imports_nothing_the_card_machine_lacks():
    """The card's machine has neither msgpack nor ml_dtypes: the port
    writes its checkpoint metadata as JSON and carries bf16 as uint16
    bits; importing its checkpoint, launchers and suites pulls in
    neither."""
    bad = {str(p.relative_to(REPO)): sorted(
        m for m in _imported_modules(p)
        if m.split(".")[0] in ("msgpack", "ml_dtypes")) for p in PORT_FILES}
    assert not {k: v for k, v in bad.items() if v}
    code = ("import sys, repro_torch.checkpoint.checkpoint, "
            "repro_torch.launch.train, repro_torch.launch.serve, "
            "repro_torch.bench.suites, repro_torch.runtime.train_loop; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('msgpack', 'ml_dtypes', 'jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_launcher_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.bridge, "
            "repro_torch.kernels.rmsnorm, repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.paged_attention, repro_torch.kernels.wkv6, "
            "repro_torch.models.ssm; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_inter_chip_modules_pull_in_no_jax():
    """The distribution layer, the Tier-2 analysis and their suites import
    nothing of JAX or the JAX package either."""
    code = ("import sys, repro_torch.launch.mesh, "
            "repro_torch.parallel.sharding, repro_torch.parallel.collectives, "
            "repro_torch.parallel.layout, repro_torch.parallel.pipeline, "
            "repro_torch.core.scalability, repro_torch.core.mesh_advisor, "
            "repro_torch.runtime.elastic, repro_torch.runtime.steps, "
            "repro_torch.bench.suites.kernels, "
            "repro_torch.bench.suites.scalability; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_analysis_and_tuner_pull_in_no_jax():
    """The static analysis, the tuned cache and the sweeps import nothing
    of JAX or the JAX package: they keep their own copies of the
    reference's findings and tuning."""
    code = ("import sys, repro_torch.analysis.__main__, "
            "repro_torch.analysis.seams, repro_torch.analysis.kernel_lint, "
            "repro_torch.analysis.graph_audit, repro_torch.kernels.tuning, "
            "repro_torch.bench.tune, repro_torch.bench.suites.tune; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_a_mesh_on_the_card_never_falls_back_to_gloo():
    """``make_mesh`` on ``cuda`` wants NCCL and a card: without a card it
    raises (setting the card fails) rather than building a gloo mesh."""
    from repro_torch.configs import MeshConfig
    from repro_torch.launch.mesh import backend_for, make_mesh
    assert backend_for("cpu") == "gloo"
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        make_mesh(MeshConfig(shape=(1, 1), axes=("data", "model")), "cuda")


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        build_engine("granite-3-8b", batch=1, prompt_len=4, max_new_tokens=2)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without a card, and alone outside a checkout, the smoke test exits
    non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, lone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and '"ok"' not in out.stdout


def test_ab_attention_refuses_to_run_without_a_card():
    """The kernel A/B script times nothing on the CPU: without a card it
    exits non-zero and prints no timing."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, str(REPO / "ab_attention.py"),
                          str(REPO)], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and '"ms_' not in out.stdout


def test_only_the_dry_run_uses_the_fake_backend():
    """The ``fake`` process group of ``torch.testing`` is the dry run's
    alone: no other file of the port names it, and the backend chooser
    never picks it."""
    from repro_torch.launch.mesh import backend_for
    users = sorted(str(p.relative_to(REPO)) for p in PORT_FILES
                   if "fake_pg" in p.read_text()
                   or '"fake"' in p.read_text())
    assert users == ["src/repro_torch/launch/dryrun.py"]
    assert {backend_for("cpu")} == {"gloo"}
    with pytest.raises(ValueError):
        backend_for("meta")


def test_dry_run_trace_and_elastic_modules_pull_in_no_jax():
    code = ("import sys, repro_torch.launch.dryrun, repro_torch.launch.cells, "
            "repro_torch.launch.trace, repro_torch.trace, "
            "repro_torch.runtime.elastic, repro_torch.core.report, "
            "repro_torch.bench.suites.scaling_matrix, "
            "repro_torch.bench.suites.trace; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"
