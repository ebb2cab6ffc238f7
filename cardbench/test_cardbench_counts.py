"""The benchmark's operation and byte counts against hand counts at
granite's shapes and at a D64 window's, and its weights against the
program's layout."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from cardbench import peaks, weights, workcount

REPO = Path(__file__).resolve().parents[1]
TRAIN = json.loads((REPO / "cardbench/traffic/train-2x4096.json")
                   .read_text())


def _config(name):
    return json.loads((REPO / f"cardbench/configs/{name}.json").read_text())


def test_causal_pairs_are_the_triangle():
    assert workcount.attention_pairs(4096, 4096, True, 0) == 4096 * 4097 // 2


def test_the_d64_window_counts_only_the_pairs_it_keeps():
    # a query keeps min(i + 1, 1024) keys
    kept = 1024 * 1025 // 2 + (4096 - 1024) * 1024
    assert workcount.attention_pairs(4096, 4096, True, 1024) == kept
    windowed = {**_config("granite-3-8b-8l"), "num_attention_heads": 25,
                "num_key_value_heads": 5, "head_dim": 64,
                "sliding_window": 1024}
    shape = workcount.training_attention_shape(windowed, TRAIN)
    assert shape == dict(B=1, Sq=4096, Sk=4096, Hq=25, Hkv=5, D=64, isz=4,
                         causal=True, window=1024)
    assert workcount.flash_forward(**shape).flops == 4 * 64 * 25 * kept


def test_granite_b2_b3_b4_a_launch():
    shape = workcount.training_attention_shape(_config("granite-3-8b-8l"),
                                               TRAIN)
    pairs = 32 * 4096 * 4097 // 2
    fwd = workcount.flash_forward(**shape, lse=True)
    assert fwd.flops == 4 * 128 * pairs
    assert fwd.bytes == 4 * 128 * (2 * 4096 * 32 + 2 * 4096 * 8) \
        + 4 * 32 * 4096
    dq = workcount.flash_dq(**shape)
    dkv = workcount.flash_dkv(**shape)
    assert dq.flops == 6 * 128 * pairs and dkv.flops == 8 * 128 * pairs
    assert dq.bytes == 4 * 128 * (3 * 4096 * 32 + 2 * 4096 * 8) \
        + 8 * 32 * 4096
    assert dkv.bytes == 4 * 128 * (2 * 4096 * 32 + 4 * 4096 * 8) \
        + 8 * 32 * 4096
    t, by = peaks.bound_s(fwd.flops, fwd.bytes, "float32")
    assert by == "ops" and t == pytest.approx(fwd.flops / 495e12)


def test_granite_train_step_flops_by_hand():
    c = _config("granite-3-8b-8l")
    tokens = 2 * 4096
    per_token = 2 * (4096 * (32 + 2 * 8) * 128 + 4096 * 4096
                     + 3 * 4096 * 12800)
    attn = 4 * 128 * 2 * 32 * (4096 * 4097 // 2)
    head = 2 * 4096 * 49155 * tokens
    want = 8 * (3 * per_token * tokens + 3.5 * attn) + 3 * head
    assert workcount.train_step_flops(c, 2, 4096) == pytest.approx(want,
                                                                   rel=1e-12)
    assert 95e12 < want < 97e12


def test_peaks_are_the_data_sheets():
    assert peaks.peak_flops("float32") == 495e12
    assert peaks.peak_flops("bfloat16") == 989e12
    assert peaks.HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("name", ["granite-3-8b-8l", "granite-3-8b"])
def test_the_weights_have_the_programs_layout(name):
    from cardbench import program
    from repro_torch.models.model import abstract_params
    c = _config(name)
    want = {".".join(p): tuple(t.shape)
            for p, t in weights.leaves(abstract_params(program.model_config(c)))}
    got = {".".join(p): shape for p, (shape, _) in weights.layout(c).items()}
    assert got == want
