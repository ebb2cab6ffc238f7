"""Operations and bytes, counted from shapes: the work of each hand kernel
per launch (a frozen copy of the port's ``kernels/work.py`` counts for the
attention kernels), and the model FLOPs of a training step.

Model FLOPs count what the model needs, not what the program runs: 2mnk
for every projection, the MLP and the output head over the true
vocabulary (the input lookup multiplies nothing); attention's QK^T and PV
over the (query, key) pairs the mask keeps. Training counts forward and
backward: products three times their forward, attention 3.5 times (the
backward at 2.5 times the forward); recomputation under remat is not
counted.
"""
from __future__ import annotations

import functools
from typing import NamedTuple


class Work(NamedTuple):
    flops: float
    bytes: float


@functools.lru_cache(maxsize=None)
def attention_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask keeps per batch row and head: key j
    for query i where j <= i (causal) and i - j < window (window > 0),
    positions from 0 on both sides."""
    total = 0
    for i in range(sq):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def flash_forward(B, Sq, Sk, Hq, Hkv, D, isz, *, causal, window,
                  lse=False) -> Work:
    """K1, or B2 with ``lse``: QK^T and PV over the kept pairs; reads q, k,
    v, writes o (and B2's f32 logsumexp rows)."""
    pairs = B * Hq * attention_pairs(Sq, Sk, causal, window)
    nbytes = isz * B * D * (2 * Sq * Hq + 2 * Sk * Hkv)
    return Work(4 * D * pairs, nbytes + (4 * B * Hq * Sq if lse else 0))


def flash_dq(B, Sq, Sk, Hq, Hkv, D, isz, *, causal, window) -> Work:
    """B3: QK^T, dO V^T and dS K over the kept pairs; reads q, k, v, dO,
    lse and delta, writes dq."""
    pairs = B * Hq * attention_pairs(Sq, Sk, causal, window)
    nbytes = isz * B * D * (3 * Sq * Hq + 2 * Sk * Hkv) + 8 * B * Hq * Sq
    return Work(6 * D * pairs, nbytes)


def flash_dkv(B, Sq, Sk, Hq, Hkv, D, isz, *, causal, window) -> Work:
    """B4: QK^T, dO V^T, P^T dO and dS^T Q over the kept pairs; reads q,
    k, v, dO, lse and delta, writes dk and dv."""
    pairs = B * Hq * attention_pairs(Sq, Sk, causal, window)
    nbytes = isz * B * D * (2 * Sq * Hq + 4 * Sk * Hkv) + 8 * B * Hq * Sq
    return Work(8 * D * pairs, nbytes)


# ------------------------------------------------------------ model FLOPs
def _linear_per_token(c: dict) -> float:
    """2 x the weights a token multiplies in one layer."""
    d, hd = c["hidden_size"], c["head_dim"]
    nq, nkv, f = c["num_attention_heads"], c["num_key_value_heads"], \
        c["intermediate_size"]
    w = d * (nq + 2 * nkv) * hd + nq * hd * d + 3 * d * f
    return 2.0 * w


def attention_forward(c: dict, rows: int, seq: int) -> float:
    """QK^T and PV over the kept pairs, one layer."""
    return 4.0 * c["head_dim"] * rows * c["num_attention_heads"] * \
        attention_pairs(seq, seq, True, c.get("sliding_window", 0))


def train_step_flops(c: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one training step over ``rows`` x ``seq`` tokens."""
    tokens = rows * seq
    layer = 3 * _linear_per_token(c) * tokens + 3.5 * attention_forward(
        c, rows, seq)
    head = 3 * 2.0 * c["hidden_size"] * c["vocab_size"] * tokens
    return c["num_hidden_layers"] * layer + head


def training_attention_shape(c: dict, t: dict) -> dict:
    """The shape of every attention launch of a training step: one
    microbatch's rows over the whole sequence, causal, the config's
    window."""
    return dict(B=t["rows"] // t["microbatches"], Sq=t["seq"], Sk=t["seq"],
                Hq=c["num_attention_heads"], Hkv=c["num_key_value_heads"],
                D=c["head_dim"], isz=4 if c["dtype"] == "float32" else 2,
                causal=True, window=c.get("sliding_window", 0))
