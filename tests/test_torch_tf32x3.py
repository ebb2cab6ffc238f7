"""The f32 arithmetic of kernels B3 and B4 on the tensor cores, emulated on
the CPU: 3xTF32 products keep f32 accuracy where single TF32 does not.

The kernels (``src/repro_torch/csrc/flash_attention_bwd.cu``) split each
f32 operand x of an m16n8k8 TF32 product into hi = tf32(x) and lo =
tf32(x - hi), both rounded to nearest with ties away from zero
(``cvt.rna.tf32.f32``), and sum lo*hi + hi*lo, then hi*hi, dropping lo*lo.
Here ``cvt.rna`` is emulated with bit operations on the f32 pattern, and a
product of TF32 values is exact in f32 (11-bit by 11-bit significands), so
an f32 matmul of TF32 values stands in for one pass of the tensor cores.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to a 10-bit mantissa, to nearest,
    ties away from zero (the sign is a separate bit, so adding half of the
    dropped 13 bits to the pattern rounds the magnitude up), then the low
    13 bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a, b):
    (ahi, alo), (bhi, blo) = split(a), split(b)
    return (alo @ bhi + ahi @ blo) + ahi @ bhi


def mm_tf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def _rand(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def test_tf32_rounding_is_to_nearest_ties_away():
    # 1 + 2^-11 is halfway between two TF32 values: away from zero
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -11, 3.0, 0.0])
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0,
                         1 + 2 ** -9, 3.0, 0.0])
    assert torch.equal(tf32_rna(x), want)
    y = _rand(np.random.default_rng(0), (4096,))
    hi, lo = split(y)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    # hi keeps 11 significant bits, hi + lo about 22
    assert float(((y - hi).abs() / y.abs()).max()) <= 2 ** -11
    assert float(((y - hi - lo).abs() / y.abs()).max()) <= 2 ** -21


def test_3xtf32_product_keeps_f32_accuracy_at_d128():
    """A 3xTF32 product with a reduction of 128 (the head dim) is within
    1e-6 of the f32 product, relative to the product's largest magnitude;
    single TF32 is not (its inputs keep ~3 decimal digits)."""
    rng = np.random.default_rng(1)
    a, b = _rand(rng, (64, 128)), _rand(rng, (128, 64))
    want = a @ b
    top = float(want.abs().max())
    err3 = float((mm_3xtf32(a, b) - want).abs().max()) / top
    err1 = float((mm_tf32(a, b) - want).abs().max()) / top
    assert err3 <= 1e-6
    assert err1 > 1e-4


def _bwd(q, k, v, do, lse, delta, mm, causal=True):
    """B3 and B4's arithmetic with the products through ``mm``: s = (q k^T)
    * scale, p = exp(s - lse) where visible, ds = p (dO V^T - delta), dq =
    ds K * scale, dk = ds^T q * scale, dv = p^T dO, summed over each GQA
    group. (B, S, H, D) inputs, f32 throughout."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qh, doh = (t.transpose(1, 2) for t in (q, do))                 # B,Hq,S,D
    kh, vh = (t.transpose(1, 2).repeat_interleave(g, dim=1) for t in (k, v))
    s = mm(qh, kh.transpose(-1, -2)) * scale
    pos_q = torch.arange(Sq)[:, None]
    pos_k = torch.arange(Sk)[None, :]
    mask = pos_q >= pos_k if causal else torch.ones(Sq, Sk, dtype=torch.bool)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (mm(doh, vh.transpose(-1, -2)) - delta[..., None])
    dq = mm(ds, kh) * scale
    dk = mm(ds.transpose(-1, -2), qh) * scale
    dv = mm(p.transpose(-1, -2), doh)
    dk, dv = (t.reshape(B, Hkv, g, Sk, D).sum(2) for t in (dk, dv))
    return tuple(t.transpose(1, 2) for t in (dq, dk, dv))


@pytest.mark.parametrize("causal", [True, False])
def test_backward_on_3xtf32_meets_the_training_tolerance(causal):
    """dq, dk and dv from 3xTF32 products stay within 1e-5 (relative, L2
    norm: phase 6 of chip_smoke.py holds loss and grad_norm to 1e-5 and
    each leaf's gradient to 1e-4) of the port's plain f32 backward; from
    single TF32 products they do not."""
    rng = np.random.default_rng(2 + int(causal))
    B, S, Hq, Hkv, D = 1, 96, 4, 2, 64
    q, do = _rand(rng, (B, S, Hq, D)), _rand(rng, (B, S, Hq, D))
    k, v = _rand(rng, (B, S, Hkv, D)), _rand(rng, (B, S, Hkv, D))
    o, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal)
    delta = ref.attention_delta(o, do)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)

    def rel(got):
        return max(float((g - w).norm() / w.norm()) for g, w in zip(got, want))

    args = (q, k, v, do, lse, delta)
    assert rel(_bwd(*args, torch.matmul, causal)) <= 1e-6   # same function
    assert rel(_bwd(*args, mm_3xtf32, causal)) <= 1e-5
    assert rel(_bwd(*args, mm_tf32, causal)) > 1e-5
