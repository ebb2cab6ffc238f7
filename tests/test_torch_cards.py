"""The port's sharded paths on several cards, one rank a card over NCCL:
the counterparts of ``tests/test_torch_parallel.py``'s gloo worlds, held
to the port's one-device runs on the same cards (the machine with the
cards has no JAX). The sharded train step at (4, 1), (2, 2) and (1, 4),
resident and streaming, with the attention through the kernels on each
rank's heads: loss and grad norm within 1e-5 (relative), one AdamW
step's params within 1e-5; serving over a (2, 2) mesh: each rank's
logits within 1e-5 of the one-device model's; a sharded checkpoint
restored 4 -> 2 -> 4 cards through ``remesh`` bit for bit; the measured
scaling matrix's dp and tp points at 1, 2 and 4 cards and its pp points
at 4 (their records printed). Each test skips, inside it, without four
cards. Run them on a machine with four cards (after
building the kernels once, so the ranks do not each build them):
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cards.py``.
"""
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from repro_torch.launch.mesh import run_with_ranks

pytestmark = pytest.mark.cuda
CARDS = 4
TIMEOUT = 600


@pytest.fixture
def cards():
    if torch.cuda.device_count() < CARDS:
        pytest.skip(f"needs {CARDS} CUDA devices")


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_on_cards(cards, shape):
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, ranks.GRANITE["vocab"], (4, 33), generator=g)
    batch = {"tokens": tokens[:, :-1].int().numpy(),
             "labels": tokens[:, 1:].int().numpy()}
    out = run_with_ranks(ranks.dp_tp_rank, CARDS, shape, None, batch,
                         "cuda", timeout=TIMEOUT, device="cuda")[0]
    loss0, gn0, p0 = out["unsharded"]
    for mode in ("resident", "streaming"):
        loss, gn, p = out[mode]
        assert abs(loss - loss0) <= 1e-5 * abs(loss0), (mode, loss, loss0)
        assert abs(gn - gn0) <= 1e-5 * abs(gn0), (mode, gn, gn0)
        err = max(float(np.abs(a - b).max()) for a, b in zip(p, p0))
        assert err < 1e-5, (mode, err)


@pytest.mark.parametrize("decode_attention", ["partitioned", "simple"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "whisper-large-v3",
                                  "arctic-480b"])
def test_sharded_serving_on_cards(cards, arch, decode_attention):
    results = run_with_ranks(ranks.serve_rank, CARDS, arch,
                             decode_attention, "cuda", timeout=TIMEOUT,
                             device="cuda")
    for out in results:
        for a, b in zip(out["mesh"], out["one"]):
            assert float(np.abs(a - b).max()) < 1e-5


def test_remesh_on_cards(cards, tmp_path):
    """A checkpoint saved from 4 cards on (2, 2) restores onto 2 cards on
    (1, 2) and back onto 4, bit for bit, each rank's block on its card."""
    want = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    d4, d2 = str(tmp_path / "d4"), str(tmp_path / "d2")
    run_with_ranks(ranks.remesh_rank, 4, None, d4, 5, want, 2, True, "cuda",
                   timeout=TIMEOUT, device="cuda")
    hops = [run_with_ranks(ranks.remesh_rank, 2, d4, d2, 6, want, 2, True,
                           "cuda", timeout=TIMEOUT, device="cuda"),
            run_with_ranks(ranks.remesh_rank, 4, d2, None, 0, want, 2, False,
                           "cuda", timeout=TIMEOUT, device="cuda")]
    for results, step, shape in zip(hops, (5, 6), ((1, 2), (2, 2))):
        for got_step, got, block, mesh in results:
            assert got_step == step and mesh == shape
            assert got.tobytes() == block.tobytes()


@pytest.mark.parametrize("scenario", ["scaling_matrix/dp",
                                      "scaling_matrix/tp",
                                      "scaling_matrix/pp"])
def test_scaling_matrix_on_cards(cards, scenario):
    """The measured matrix on NCCL ranks, one card a rank: the points of
    up to four ranks run (dp 1-4, tp 2-4, pp at 4) and lie in the
    reference's ranges; the 8-rank points are named as not run. The pp
    splits (granite's width, 8,192 tokens) obey the most-loaded-stage
    model (``model_ok``) and its ordering, as the reference's
    ``scaling-efficiency`` check holds them."""
    import json

    import repro_torch.bench.suites  # noqa: F401  (registers them)
    from repro_torch.bench import BenchRunner, ListSink, select
    from repro_torch.bench.__main__ import with_device

    sink = ListSink()
    out = BenchRunner(sinks=[sink]).run(
        [with_device(s, "cuda") for s in select(only=scenario)])
    assert out.ok, out.failures
    for rec in sink.records:
        print(json.dumps({"record": rec.name, "us": float(rec.us_per_call),
                          "derived": rec.derived}))
        d = rec.derived
        if "not_run" in d:
            assert d["ranks"] > CARDS
            continue
        assert d["tok_s"] > 0
        if "efficiency" in d:
            assert 0 < d["efficiency"] <= 4.0
            assert 0 <= d["collective_frac"] < 1
            assert 0 <= d["shard_balance"] <= 1
    ran = [r for r in sink.records if "not_run" not in r.derived]
    assert len(ran) == {"scaling_matrix/dp": 3, "scaling_matrix/tp": 2,
                        "scaling_matrix/pp": 3}[scenario]
    pp = sorted((r for r in ran if "/pp_" in r.name),
                key=lambda r: r.derived["max_stage"])
    for r in pp:
        assert r.derived["model_ok"], (r.name, r.derived)
    for a, b in zip(pp, pp[1:]):
        assert a.derived["tok_s"] > 0.9 * b.derived["tok_s"], (a.name, b.name)
