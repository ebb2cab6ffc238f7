import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
sys.path.insert(0, str(SRC))
# make the _hypothesis_compat shim importable regardless of import mode
sys.path.insert(0, str(Path(__file__).resolve().parent))


def run_with_devices(code: str, n_devices: int = 8, timeout: int = 600):
    """Run a python snippet in a subprocess with N fake host devices.
    (The main pytest process must keep seeing 1 device — see dryrun.py.)
    Env via launch/mesh.host_device_env: only the count flag is rewritten,
    so a CI cell's other XLA_FLAGS survive into the child."""
    from repro.launch.mesh import host_device_env

    env = host_device_env(n_devices)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed\nSTDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}")
    return proc.stdout


@pytest.fixture
def tmp_ckpt_dir(tmp_path):
    return str(tmp_path / "ckpt")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips inside the test without one")
