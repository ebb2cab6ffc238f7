"""Whole runs of toy cells on the CPU, past the harness's look for a card:
sound runs come out correct; the timed path broken underneath, or the
control in the program's place, comes out not correct; the result line has
exactly the contract's keys; toy cells added as new files run without an
edit of any file that was there."""
from __future__ import annotations

import json
import math
import subprocess
import sys

import pytest
import torch

from cardbench import compare, harness
from cardbench.conftest import REPO, TOY_CELLS, add_toy_cells, run_toy
from cardbench.conftest import tree_digest
from cardbench.drivers import train as train_driver

LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device",
             "checks"}


@pytest.mark.parametrize("workload", sorted(TOY_CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_toy_run_is_correct(toy_root, workload, trace):
    line = run_toy(toy_root, workload, trace=trace)
    assert line["correct"], line["checks"]
    assert set(line) - {"breakdown"} == LINE_KEYS
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    cell = harness.load_cell(toy_root, workload)
    want = [m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)]
    assert set(line["metrics"]) <= set(want)
    if not trace:
        assert set(line["metrics"]) == set(want)
        assert all(math.isfinite(m["value"]) and m["value"] > 0
                   for n, m in line["metrics"].items()
                   if n != "train_peak_gib")
    else:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    json.loads(json.dumps(line, allow_nan=False))


def test_toy_cells_added_as_new_files_leave_every_file_as_it_was(tmp_path):
    import shutil
    shutil.copytree(REPO / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = tree_digest(tmp_path / "cardbench")
    add_toy_cells(tmp_path)
    after = tree_digest(tmp_path / "cardbench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert len(after) > len(before)
    for name in TOY_CELLS:
        cell = harness.load_cell(tmp_path, name)
        assert cell.config["name"] == TOY_CELLS[name][0]


def test_a_new_per_layer_metric_is_a_new_file(toy_root):
    path = toy_root / "cardbench" / "metrics" / "steps.toy.py"
    path.write_text('"""steps.toy: window steps."""\n\n\ndef read(ctx):\n'
                    '    return float(ctx["counts"]["steps"])\n')
    read = harness.reader(toy_root, "steps.toy")
    assert read({"counts": {"steps": 3}}) == 3.0
    assert harness.reader_path(toy_root, "steps.toy") == path


def _no_update(self, grads, state, params, gnorm=None):
    return params, state, {"grad_norm": torch.zeros(()), "lr": 0.0}


def _half_batch(real):
    def accumulate(model, params, batch, microbatches, acc_dtype=None):
        rows = batch["labels"].shape[0] // 2
        return real(model, params, {k: v[:rows] for k, v in batch.items()},
                    1, acc_dtype)
    return accumulate


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(toy_root, monkeypatch, fault):
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime import steps
    if fault == "state_unchanged":
        monkeypatch.setattr(AdamW, "update", _no_update)
    else:
        monkeypatch.setattr(steps, "accumulate_grads",
                            _half_batch(steps.accumulate_grads))
    line = run_toy(toy_root, "toy-dense.train")
    assert not line["correct"], line["checks"]


def test_an_altered_served_token_is_not_correct(toy_root, monkeypatch):
    from repro_torch.serving import paged
    real = paged._sample_tokens
    calls = {"n": 0}

    def altered(logits, gen, greedy):
        tok = real(logits, gen, greedy)
        calls["n"] += 1
        return (tok + 1) % 512 if calls["n"] % 7 == 0 else tok

    monkeypatch.setattr(paged, "_sample_tokens", altered)
    line = run_toy(toy_root, "toy-dense.serve")
    assert not line["correct"], line["checks"]


def test_the_control_in_tf32_fails_the_limits(toy_root):
    """The reference computed in TF32, in the program's place, against the
    reference in float32, on three seeds: it has to fail a limit."""
    cell = harness.load_cell(toy_root, "toy-dense.train")
    dev = torch.device("cpu")
    for seed in (3, 2 ** 32 + 9, 12345):
        ref = train_driver.reference_readings(cell.config, cell.traffic,
                                              seed, dev)
        low = train_driver.reference_readings(cell.config, cell.traffic,
                                              seed, dev, precision="tf32")
        nums = compare.train_numbers(low, ref)
        assert any(nums[k] > lim for k, lim in cell.limits.items()), nums


def test_the_control_in_tf32_moves_served_logits(toy_root):
    """The serving control, the reference in TF32 in the program's place,
    through the check's own numbers over a seed's prompt and a thousand
    tokens: its logits lie farther from the float32 reference's than the
    limit, on three seeds."""
    from cardbench.drivers import serve
    cell = harness.load_cell(toy_root, "toy-dense.serve")
    errs = []
    for seed in (3, 4, 5):
        prompt = torch.randint(1, 500, (100,), generator=torch.Generator()
                               .manual_seed(seed)).numpy().astype("int32")
        tok = torch.randint(1, 500, (900,), generator=torch.Generator()
                            .manual_seed(seed + 1)).numpy()
        # zeros stand in for the program's rows: the test reads the control
        rows = torch.zeros(len(tok), cell.config["vocab_size"])
        nums = serve.check_numbers(
            cell.config, [(prompt, tok, rows, list(range(len(tok))))], seed,
            torch.device("cpu"), control=True)
        errs.append(nums["control"]["logit_err"])
    assert min(errs) > cell.limits["logit_err"], errs


def test_served_logits_a_little_off_are_not_correct(toy_root, monkeypatch):
    """Every logit the program serves scaled by 1 + 1e-3: no greedy token
    changes, so only the program's logits against the reference's can
    see it."""
    from repro_torch.models import model
    real = model.lm_logits

    def scaled(*a, **k):
        return real(*a, **k) * (1 + 1e-3)

    monkeypatch.setattr(model, "lm_logits", scaled)
    line = run_toy(toy_root, "toy-dense.serve")
    assert line["checks"]["logit_gap"]["value"] == 0.0
    assert not line["correct"], line["checks"]


def test_the_watch_keeps_a_row_for_every_served_token(toy_root):
    """The program's logits kept on the timed path: one row a served token
    of every planned request, at the positions that produced them, and
    the served tokens are those rows' greedy choices."""
    from cardbench import traffic as tr
    from cardbench.drivers import serve
    cell = harness.load_cell(toy_root, "toy-dense.serve")
    dev = torch.device("cpu")
    srv, t, _ = serve.setup(cell, 11, dev)
    arrivals = tr.open_loop(11, 1.0, t, cell.config["vocab_size"])
    report, watch = serve.window(srv, arrivals, 11, t)
    served = watch.served(report)
    assert len(served) == len(serve.plan(arrivals, 11, t["check"])) > 1
    for prompt, tok, rows, at in served:
        assert len(rows) == len(tok) and list(at) == list(range(len(tok)))
        assert rows.argmax(-1).tolist() == list(tok)


def test_the_harness_loads_neither_jax_nor_the_jax_package(toy_root):
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        "from cardbench import harness\n"
        f"cell = harness.load_cell(__import__('pathlib').Path({str(toy_root)!r}),"
        " 'toy-dense.train')\n"
        "harness.run(cell, 5, 0.5, 1, torch.device('cpu'), time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))
    assert "repro_torch" in mods and "cardbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}
