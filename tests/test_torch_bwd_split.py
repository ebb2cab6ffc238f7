"""f32 B4 (dk, dv) with its GQA group split over a thread-block cluster,
emulated on the CPU and held to the JAX package's backward.

Where B4's grid of (key tile, kv head, batch row) blocks underfills the
card, ``csrc/flash_attention_bwd.cu`` launches clusters of c blocks (c from
``analysis/kernel_lint.py::bwd_cluster``, the mirror of ``dkv_cluster``):
rank r walks the key tile's q heads r G/c .. (r + 1) G/c - 1, each over its
q tiles of 32 rows, summing every step's dK and dV in a fresh 3xTF32
accumulator folded into the rank's partial in f32; the c partials are then
summed in rank order through distributed shared memory. ``_split_dkv``
does the same arithmetic with the 3xTF32 emulation of
``test_torch_tf32x3.py`` (an f32 matmul of TF32 values stands in for one
pass of the tensor cores).

Tolerance: atol = rtol = 1e-5 in f32, as ``test_torch_train_kernels.py``.
The Pallas backward drops tail rows when its blocks do not tile the
sequence, so at the ragged S of these cases it runs with one block the
length of the sequence.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import (flash_attention_bwd,
                                           flash_attention_fwd)
from repro_torch.analysis import kernel_lint
from test_torch_tf32x3 import mm_3xtf32

torch.set_num_threads(2)
TOL = 1e-5
LOG2E = 1.4426950408889634
KEYS, QROWS = 64, 32      # B4's resident key rows and f32 query tile


def _split_dkv(q, k, v, do, lse, delta, causal, ranks):
    """One kv head's dk and dv (Sk, D) as f32 B4 computes them with its
    group split over ``ranks`` blocks: q and do (Sq, G, D) of the group's
    heads, k and v (Sk, D), lse and delta (G, Sq)."""
    Sq, G, D = q.shape
    Sk = k.shape[0]
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    scale2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    heads = G // ranks
    dk, dv = torch.zeros(Sk, D), torch.zeros(Sk, D)
    for k0 in range(0, Sk, KEYS):
        kt, vt = k[k0:k0 + KEYS], v[k0:k0 + KEYS]
        kp = torch.arange(k0, k0 + len(kt))[:, None]
        parts = []
        for r in range(ranks):
            pk, pv = torch.zeros(len(kt), D), torch.zeros(len(kt), D)
            for h in range(r * heads, (r + 1) * heads):
                for q0 in range((k0 // QROWS) * QROWS if causal else 0, Sq,
                                QROWS):
                    qt, dot = q[q0:q0 + QROWS, h], do[q0:q0 + QROWS, h]
                    qp = torch.arange(q0, q0 + len(qt))[None, :]
                    seen = qp >= kp if causal else torch.ones_like(qp >= kp)
                    pt = torch.where(seen, torch.exp2(
                        mm_3xtf32(kt, qt.T) * scale2
                        - lse[h, q0:q0 + QROWS] * LOG2E), 0.0)
                    dst = pt * (mm_3xtf32(vt, dot.T)
                                - delta[h, q0:q0 + QROWS])
                    pv = pv + mm_3xtf32(pt, dot)     # the step's fold
                    pk = pk + mm_3xtf32(dst, qt)
            parts.append((pk, pv))
        sk, sv = parts[0]
        for pk, pv in parts[1:]:                      # rank order
            sk, sv = sk + pk, sv + pv
        dk[k0:k0 + KEYS], dv[k0:k0 + KEYS] = sk * scale, sv
    return dk, dv


def _inputs(G, S, D, causal, seed):
    """numpy inputs from a seed; o and lse from the JAX forward."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((1, S, G, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, S, 1, D)).astype(np.float32)
            for _ in range(2))
    qj, kj, vj, doj = (jnp.asarray(x) for x in (q, k, v, do))
    oj, lsej = flash_attention_fwd(qj, kj, vj, causal=causal, block_q=S,
                                   block_k=S, interpret=True, return_lse=True)
    o, lse = np.asarray(oj), np.asarray(lsej)
    delta = (do * o).sum(-1).transpose(0, 2, 1)               # (1, G, S)
    return (q, k, v, do, o, lse, delta), (qj, kj, vj, oj, lsej, doj)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 4, 5, 7, 8, 12])
def test_split_b4_matches_the_pallas_backward(G, causal):
    """dk and dv of the split B4 (its cluster by the launch rule at B1 S100
    with one kv head: the group's largest divisor at most 8) within 1e-5 of
    the Pallas backward in interpret mode; the same sums twice give the
    same bits, and the unsplit walk agrees within the tolerance."""
    S, D = 100, 32
    (q, k, v, do, o, lse, delta), jx = _inputs(G, S, D, causal, 17 * G +
                                               int(causal))
    ranks = kernel_lint.bwd_cluster(1, S, 1, G, "float32")
    assert ranks == max(c for c in range(1, 9) if G % c == 0)
    _, want_dk, want_dv = flash_attention_bwd(
        *jx[:3], jx[3], jx[4], jx[5], causal=causal, block_q=S, block_k=S,
        interpret=True)
    args = [torch.from_numpy(np.array(x, dtype=np.float32)) for x in (
        q[0], k[0, :, 0], v[0, :, 0], do[0], lse[0], delta[0])]
    dk, dv = _split_dkv(*args, causal, ranks)
    again = _split_dkv(*args, causal, ranks)
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])
    for got, want in ((dk, want_dk), (dv, want_dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[0, :, 0],
                                   atol=TOL, rtol=TOL)
    one = _split_dkv(*args, causal, 1)
    for a, b in zip((dk, dv), one):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)
