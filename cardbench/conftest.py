"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with toy
cells added as new files only (a reduced dense configuration,
small training and serving mixes, their limits), run on the CPU through
the program's plain kernel versions."""
from __future__ import annotations

import hashlib
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
for _p in (REPO / "src", REPO):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

TOY = {"hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
       "num_key_value_heads": 4, "head_dim": 32, "intermediate_size": 256,
       "vocab_size": 512, "program_reduced": {}}
TOY_CELLS = {"toy-dense.train": ("toy-dense", "toy-train"),
             "toy-dense.serve": ("toy-dense", "toy-serve")}
# each toy cell reports the metrics of the cell it stands for
STANDS_FOR = {"toy-dense.train": "granite-3-8b.train",
              "toy-dense.serve": "granite-3-8b.serve"}
TOY_LIMITS = {"toy-dense.train": {"loss": 1e-5, "grad": 1e-4, "change": 1e-4},
              "toy-dense.serve": {"logit_gap": 1e-5, "logit_err": 1e-4}}


def _read(rel: str) -> dict:
    return json.loads((REPO / "cardbench" / rel).read_text())


def add_toy_cells(root: Path) -> None:
    """Add the toy cells to the benchmark copied under ``root``: new
    configuration, mix and limits files, and new entries in its
    BENCHMARK.json."""
    base = root / "cardbench"
    dense = {**_read("configs/granite-3-8b.json"), **TOY, "name": "toy-dense"}
    train = {**_read("traffic/train-2x4096.json"), "seq": 100}
    serve = {**_read("traffic/chat-open-loop.json"), "rate_per_s": 12.0,
             "engine": {"scheduler": "paged", "slots": 4, "page_size": 16,
                        "prefill_chunk_tokens": 32},
             "prompt": {"median": 24, "sigma": 0.8, "min": 8, "max": 64},
             "output": {"median": 6, "sigma": 0.5, "min": 2, "max": 12},
             "check": {"min_tokens": 30, "max_requests": 4},
             "traced_replay_s": 0.5, "traced_from_s": 0.1,
             "traced_decode_steps": 5}
    files = {"configs/toy-dense.json": dense}
    files.update({"traffic/toy-train.json": train,
                  "traffic/toy-serve.json": serve})
    files.update({f"limits/{n}.json": v for n, v in TOY_LIMITS.items()})
    for rel, obj in files.items():
        path = base / rel
        assert not path.exists(), f"{rel} would overwrite a file"
        path.write_text(json.dumps(obj, indent=1))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, (config, mix) in TOY_CELLS.items():
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": mix, "chips": 1, "why": "toy"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if STANDS_FOR[name] in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def tree_digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cardbench_toy")
    shutil.copytree(REPO / "cardbench", root / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    add_toy_cells(root)
    return root


def run_toy(root: Path, workload: str, *, seed: int = 2 ** 31 + 7,
            seconds: float = 1.0, trace: int = 0) -> dict:
    """One run of a toy cell on the CPU, through the harness as
    ``cardbench/run.py`` drives it past its look for a card."""
    import time

    import torch

    from cardbench import harness
    cell = harness.load_cell(root, workload)
    line, _ = harness.run(cell, seed, seconds, trace, torch.device("cpu"),
                          time.perf_counter())
    return line
