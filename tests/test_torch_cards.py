"""The port's sharded paths on several cards, one rank a card over NCCL:
the counterparts of ``tests/test_torch_parallel.py``'s gloo worlds, held
to the port's one-device runs on the same cards (the machine with the
cards has no JAX). The sharded train step at (4, 1), (2, 2) and (1, 4),
resident and streaming, with the attention through the kernels on each
rank's heads: loss and grad norm within 1e-5 (relative), one AdamW
step's params within 1e-5; serving over a (2, 2) mesh: each rank's
logits within 1e-5 of the one-device model's. Each test skips, inside
it, without four cards. Run them on a machine with four cards (after
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
