"""f32 K1/B2 (the forward) with the key range split over a thread-block
cluster or the warp groups of one block, emulated on the CPU and held to
the JAX package's forward.

Where the forward's grid of (q tile, q head, batch row) blocks underfills
the card, ``csrc/flash_attention.cu`` launches clusters of c blocks per q
tile (c from ``analysis/kernel_lint.py::fwd_cluster``, the mirror of
``fwd_cluster``), or, where the key range is short, splits it over the two
warp groups of one block (``fwd_halves``: two ranks). The first n = min(c,
the tile's key tiles) ranks walk contiguous, near-equal shares of the
tile's 32-key tiles, each with its own running max, row sum and output
accumulator (every tile's P V in a fresh 3xTF32 sum folded in f32), and
the ranks' partials are combined in rank order: m = max m_r, w_r = 2^(m_r - m), l = sum l_r w_r, o = (sum acc_r w_r)
/ max(l, 1e-30), lse = m ln 2 + log(max(l, 1e-30)). ``_split_fwd`` does the
same arithmetic with the 3xTF32 emulation of ``test_torch_tf32x3.py`` (an
f32 matmul of TF32 values stands in for one pass of the tensor cores);
``_unsplit_fwd`` is the one-block walk the unsplit kernel makes.

Tolerance: atol = rtol = 1e-5 in f32, as ``test_torch_train_kernels.py``.
The Pallas forward raises where its blocks do not tile the sequence, so it
runs with one block the length of the sequence (block_q = Sq, block_k =
Sk), in interpret mode, as the JAX package's own tests run it.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention_fwd
from repro_torch.analysis import kernel_lint
from test_torch_tf32x3 import mm_3xtf32

torch.set_num_threads(2)
TOL = 1e-5
LOG2E = 1.4426950408889634
MASKED = -1e30 * LOG2E    # the kernels' masked score, in log2 units
BQ, BK = 64, 32           # the f32 forward's q rows a block, keys a tile


def _visible(q0, nq, k0, nk, Sk, causal, window):
    """The mask of a (q tile, key tile) pair, as ``attn::visible``."""
    qp = torch.arange(q0, q0 + nq)[:, None]
    kp = torch.arange(k0, k0 + nk)[None, :]
    ok = kp < Sk
    if causal:
        ok = ok & (qp >= kp)
    if window > 0:
        ok = ok & (qp - kp < window)
    return ok


def _key_tiles(q0, Sk, causal, window):
    """The tile's key tiles, from the window bound to the causal bound."""
    k_end = min(Sk, q0 + BQ) if causal else Sk
    k_begin = max(0, q0 - window + 1) if causal and window > 0 else 0
    if k_end <= k_begin:
        return []
    return list(range(k_begin // BK, -(-k_end // BK)))


def _walk(q, k, v, q0, tiles, causal, window):
    """One rank's online softmax over ``tiles`` for the q tile at q0: its
    running max m (log2 units), row sum l and unnormalised output acc."""
    nq, D = q.shape
    Sk = k.shape[0]
    scale2 = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32) \
        * torch.tensor(LOG2E, dtype=torch.float32)
    m = torch.full((nq, 1), MASKED)
    l = torch.zeros(nq, 1)
    acc = torch.zeros(nq, D)
    for t in tiles:
        k0 = t * BK
        kt, vt = k[k0:k0 + BK], v[k0:k0 + BK]
        x = torch.where(_visible(q0, nq, k0, len(kt), Sk, causal, window),
                        mm_3xtf32(q, kt.T) * scale2, MASKED)
        m_new = torch.maximum(m, x.max(-1, keepdim=True).values)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + mm_3xtf32(p, vt)     # a fresh sum, folded
        m = m_new
    return m, l, acc


def _finish(m, l, acc):
    denom = l.clamp_min(1e-30)
    return acc * (1.0 / denom), (m * math.log(2) + torch.log(denom))[:, 0]


def _unsplit_fwd(q, k, v, causal, window):
    """One q head's o (Sq, D) and lse (Sq,) as the unsplit kernel walks
    them: q (Sq, D), k and v (Sk, D) of its kv head."""
    Sq, _ = q.shape
    outs, lses = [], []
    for q0 in range(0, Sq, BQ):
        qt = q[q0:q0 + BQ]
        o, lse = _finish(*_walk(qt, k, v, q0, _key_tiles(
            q0, k.shape[0], causal, window), causal, window))
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs), torch.cat(lses)


def _split_fwd(q, k, v, causal, window, ranks):
    """The same head with each q tile's key tiles split over ``ranks``
    blocks and combined in rank order."""
    Sq, _ = q.shape
    outs, lses = [], []
    for q0 in range(0, Sq, BQ):
        qt = q[q0:q0 + BQ]
        tiles = _key_tiles(q0, k.shape[0], causal, window)
        n = max(1, min(ranks, len(tiles)))
        parts = [_walk(qt, k, v, q0, tiles[r * len(tiles) // n:
                                            (r + 1) * len(tiles) // n],
                       causal, window) for r in range(n)]
        m = parts[0][0]
        for mr, _, _ in parts[1:]:
            m = torch.maximum(m, mr)
        w = [torch.exp2(mr - m) for mr, _, _ in parts]
        l, o = parts[0][1] * w[0], parts[0][2] * w[0]
        for (_, lr, ar), wr in zip(parts[1:], w[1:]):       # rank order
            l, o = l + lr * wr, o + ar * wr
        o, lse = _finish(m, l, o)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs), torch.cat(lses)


def _heads(fn, q, k, v, *args):
    """``fn`` per q head of (B, S, H, D) inputs: o (B, Sq, Hq, D), lse
    (B, Hq, Sq)."""
    B, Sq, Hq, D = q.shape
    g = Hq // k.shape[2]
    o = torch.zeros(B, Sq, Hq, D)
    lse = torch.zeros(B, Hq, Sq)
    for b in range(B):
        for h in range(Hq):
            o[b, :, h], lse[b, h] = fn(q[b, :, h], k[b, :, h // g],
                                       v[b, :, h // g], *args)
    return o, lse


# (B, Sq, Sk, Hq, Hkv, D, causal, window): 11b's causal S128 at head dim
# 128 (heads cut from 40:8 to 10:2), a sliding window, whisper's
# non-causal cross attention at Sq4 Sk1499 (one 4-row q tile, 47 key
# tiles), and a ragged causal Sq
SHAPES = [(1, 128, 128, 10, 2, 128, True, 0),
          (1, 160, 160, 4, 2, 64, True, 48),
          (2, 4, 1499, 4, 4, 64, False, 0),
          (1, 100, 100, 4, 1, 64, True, 0)]


@pytest.fixture(scope="module", params=SHAPES,
                ids=lambda s: "B{} Sq{} Sk{} Hq{}:{} D{} {}{}".format(
                    *s[:6], "causal" if s[6] else "non-causal",
                    f" window{s[7]}" if s[7] else ""))
def case(request):
    """Seeded numpy inputs, the JAX forward's o and lse, and the unsplit
    emulation, once per shape."""
    B, Sq, Sk, Hq, Hkv, D, causal, window = request.param
    rng = np.random.default_rng(Sq * 7 + Sk + D + window)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
            for _ in range(2))
    oj, lsej = flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=Sq, block_k=Sk, interpret=True,
        return_lse=True)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    unsplit = _heads(_unsplit_fwd, *args, causal, window)
    return (args, (causal, window), (np.asarray(oj), np.asarray(lsej)),
            unsplit)


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_split_forward_matches_the_pallas_forward(case, ranks):
    """o and lse of the forward with its key range split over ``ranks``
    blocks within 1e-5 of the Pallas forward in interpret mode; the same
    split twice gives the same bits, and one rank gives the unsplit walk's
    bits (its combine multiplies by 2^0 = 1)."""
    args, (causal, window), want, unsplit = case
    got = _heads(_split_fwd, *args, causal, window, ranks)
    again = _heads(_split_fwd, *args, causal, window, ranks)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if ranks == 1:
        assert all(torch.equal(a, b) for a, b in zip(got, unsplit))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL)


def test_the_split_shapes_are_the_launch_rule():
    """The split the launch rule picks at the models' widths: whisper's
    cross attention splits its 47 key tiles eight ways over a cluster at
    B4 Sq4 Sk1500 and at B1 Sq128; 11b's B1 S128 Hq40:8 and the windowed
    and ragged lengths above at its heads (four or five key tiles: a
    cluster's rank needs four) split over the two warp groups of one block
    (the two-rank case above); no bf16 launch splits."""
    assert kernel_lint.fwd_cluster(4, 4, 1500, 20, 64, "float32") == 8
    assert kernel_lint.fwd_cluster(1, 128, 1500, 20, 64, "float32") == 8
    assert not kernel_lint.fwd_halves(1, 128, 1500, 20, 64, "float32")
    for S, D in ((128, 128), (160, 64), (100, 64)):
        assert kernel_lint.fwd_cluster(1, S, S, 40, D, "float32") == 1
        assert kernel_lint.fwd_halves(1, S, S, 40, D, "float32")
    assert kernel_lint.fwd_cluster(4, 4, 1500, 20, 64, "bfloat16") == 1
    assert not kernel_lint.fwd_halves(1, 128, 128, 40, 128, "bfloat16")
