"""The arithmetic of the flash-attention kernels on the tensor cores,
emulated on the CPU: 3xTF32 products keep f32 accuracy where single TF32
does not (the backward, B3 and B4, and the forward, K1 and B2), and the
forward's bf16 P V keeps the output within a unit of bf16 rounding of the
reference only with P in two bf16 terms.

The kernels (``src/repro_torch/csrc/flash_attention_bwd.cu`` and
``flash_attention.cu``) split each f32 operand x of an m16n8k8 TF32
product into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest
with ties away from zero (``cvt.rna.tf32.f32``), and sum lo*hi + hi*lo,
then hi*hi, dropping lo*lo. The kernels compute ``cvt.rna`` with integer
operations on the f32 pattern, as ``tf32_rna`` does here (``mma.cuh``
``to_tf32``), and a product of TF32 values is exact in
f32 (11-bit by 11-bit significands), so an f32 matmul of TF32 values
stands in for one pass of the tensor cores; so does an f32 matmul of bf16
values for a bf16 pass.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

REPO = Path(__file__).resolve().parents[1]


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


# ------------------------------------------------------------ the forward
LOG2E = 1.4426950408889634
MASKED = -1e30 * LOG2E    # the reference's masked score, in log2 units


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def pv_bf16_two_terms(p, v):
    """p_hi = bf16(p), p_lo = bf16(p - p_hi), two products on bf16 v; the
    kernel sums p_lo v first, then p_hi v, in one fresh accumulator."""
    hi = _bf16(p)
    return _bf16(p - hi) @ v + hi @ v


def pv_bf16_one_term(p, v):
    """P rounded once to bf16, as FlashAttention-2 (and B3/B4 for their
    second products) feed the tensor cores."""
    return _bf16(p) @ v


def _fwd(q, k, v, *, mm_s, pv, bk):
    """K1/B2's arithmetic on one head, causal: q (S, D), k and v (S, D) f32
    (bf16 values in f32 for bf16 inputs). Key tiles of ``bk`` rows in
    order, every row through every tile (a tile a row cannot see gives p =
    0 and corr = 1, so the result is the kernel's, which skips it): s =
    ``mm_s``(q, k_tile^T) from unscaled q, x = s * scale * log2(e) or the
    masked value, the running max m, corr = exp2(m_old - m), p = exp2(x -
    m), l = l corr + rowsum(p), and acc = acc corr + ``pv``(p, v_tile)
    from a fresh sum per tile. Returns acc / max(l, 1e-30) and lse = m ln 2
    + log(max(l, 1e-30))."""
    S, D = q.shape
    scale2 = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32) \
        * torch.tensor(LOG2E, dtype=torch.float32)
    qpos = torch.arange(S)[:, None]
    m = torch.full((S, 1), MASKED)
    l = torch.zeros(S, 1)
    acc = torch.zeros(S, D)
    for k0 in range(0, S, bk):
        kt, vt = k[k0:k0 + bk], v[k0:k0 + bk]
        x = torch.where(qpos >= torch.arange(k0, k0 + len(kt))[None, :],
                        mm_s(q, kt.T) * scale2, MASKED)
        m_new = torch.maximum(m, x.max(-1, keepdim=True).values)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + pv(p, vt)
        m = m_new
    denom = l.clamp_min(1e-30)
    return acc / denom, (m * math.log(2) + torch.log(denom))[:, 0]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def one_head():
    """q, k, v of one head at the training shape (S4096 D128), seeded."""
    rng = np.random.default_rng(4)
    q, k, v = (_rand(rng, (1, 4096, 1, 128)) for _ in range(3))
    return q, k, v


def _want(q, k, v):
    o, lse = ref.flash_attention_lse_ref(q, k, v, causal=True)
    return o[0, :, 0], lse[0, 0]


def test_forward_on_3xtf32_meets_the_f32_budget(one_head):
    """The forward's f32 arithmetic (3xTF32 for Q K^T and P V, 32-key
    tiles) keeps the output and lse within 1e-6 of the plain f32 forward,
    relative to their largest magnitudes."""
    q, k, v = one_head
    o_want, lse_want = _want(q, k, v)
    o, lse = _fwd(q[0, :, 0], k[0, :, 0], v[0, :, 0], mm_s=mm_3xtf32,
                  pv=mm_3xtf32, bk=32)
    assert float((o - o_want).abs().max() / o_want.abs().max()) <= 1e-6
    assert float((lse - lse_want).abs().max()
                 / lse_want.abs().max()) <= 1e-6


@pytest.mark.parametrize("pv,held", [(pv_bf16_two_terms, True),
                                     (pv_bf16_one_term, False)])
def test_forward_bf16_needs_p_in_two_terms(one_head, pv, held):
    """In bf16 (64-key tiles, exact bf16 products for Q K^T), the output
    rounded to bf16 stays within one unit of bf16 rounding of the plain
    forward computed in f32 from the same bf16 inputs (phase 2's gate,
    ``chip_smoke._ulp_err``) with P as two bf16 terms, and not with P
    rounded once to bf16: that case is why the kernel keeps two."""
    smoke = _smoke()
    q, k, v = (_bf16(t) for t in one_head)
    o_want, _ = _want(q, k, v)
    o, _ = _fwd(q[0, :, 0], k[0, :, 0], v[0, :, 0], mm_s=torch.matmul,
                pv=pv, bk=64)
    err = smoke._ulp_err(o.to(torch.bfloat16), o_want)
    assert (err <= smoke.ULP_TOL) == held, err


@pytest.fixture(scope="module")
def one_head_d64():
    """q, k, v of one head at S4096 D64 (the wgmma kernel's 128-key tiles),
    seeded."""
    rng = np.random.default_rng(64)
    return tuple(_rand(rng, (1, 4096, 1, 64)) for _ in range(3))


@pytest.mark.parametrize("d,bk", [(128, 64), (64, 128)])
@pytest.mark.parametrize("pv,held", [(pv_bf16_two_terms, True),
                                     (pv_bf16_one_term, False)])
def test_forward_bf16_wgmma_tiles_need_p_in_two_terms(one_head, one_head_d64,
                                                      d, bk, pv, held):
    """The bf16 forward on wgmma (``attn_fwd_kernel_wgmma``) at its key
    tiles: 64 keys at D128, 128 at D64, each tile's P V in a fresh
    accumulator folded in f32 (per 64 columns of D: the same sums, column
    by column). At S4096, one head, the output rounded to bf16 is within
    one unit of bf16 rounding of the plain forward in f32 with P as two
    bf16 terms, and not with P rounded once."""
    smoke = _smoke()
    q, k, v = (_bf16(t) for t in (one_head if d == 128 else one_head_d64))
    o_want, _ = _want(q, k, v)
    o, _ = _fwd(q[0, :, 0], k[0, :, 0], v[0, :, 0], mm_s=torch.matmul,
                pv=pv, bk=bk)
    err = smoke._ulp_err(o.to(torch.bfloat16), o_want)
    assert (err <= smoke.ULP_TOL) == held, err


# -------------------------------------------- the bf16 backward on wgmma
def _bwd_wgmma_tiles(q, k, v, do, lse, delta, causal, bn=64):
    """B3's and B4's arithmetic on their wgmma kernels for one kv head:
    q, do (S, G, D) of its GQA group's G q heads, k, v (S, D), lse and
    delta (G, S), bf16 values in f32. Products of bf16 values summed in f32
    stand in for the tensor cores. p = exp2(s * scale * log2(e) - lse *
    log2(e)) where visible, else 0; ds = p (dp - delta) formed in f32; p
    and ds rounded once to bf16 as the second products' A operand; dQ, dK
    and dV accumulated directly across tiles, in the kernels' order. B3
    (dq): per head, every key tile of ``bn`` keys in order for all q rows
    at once (a tile past a row's causal bound adds exact zeros, which the
    kernel skips). B4 (dk, dv): the group's heads head-major, each over its
    q tiles of ``bn`` rows in order, for all keys at once (the transposed
    scores S^T = K Q^T, dP^T = V dO^T). Returns dq (S, G, D), dk and dv
    (S, D), dq and dk times the scale."""
    S, G, D = q.shape
    scale2 = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32) \
        * torch.tensor(LOG2E, dtype=torch.float32)
    lse2 = lse * LOG2E
    pos = torch.arange(S)
    qh, doh = q.transpose(0, 1), do.transpose(0, 1)          # G, S, D
    dq = torch.zeros(G, S, D)
    for k0 in range(0, S, bn):
        kt, vt = k[k0:k0 + bn], v[k0:k0 + bn]
        seen = (pos[:, None] >= pos[None, k0:k0 + bn]) if causal else \
            torch.ones(S, len(kt), dtype=torch.bool)
        p = torch.where(seen, torch.exp2(qh @ kt.T * scale2
                                         - lse2[..., None]), 0.0)
        ds = p * (doh @ vt.T - delta[..., None])
        dq += _bf16(ds) @ kt
    dk, dv = torch.zeros(S, D), torch.zeros(S, D)
    for h in range(G):
        for q0 in range(0, S, bn):
            qt, dot = q[q0:q0 + bn, h], do[q0:q0 + bn, h]
            keys = q0 + len(qt) if causal else S      # keys that can be seen
            seen = (pos[q0:q0 + bn][None, :] >= pos[:keys, None]) \
                if causal else torch.ones(keys, len(qt), dtype=torch.bool)
            pt = torch.where(seen, torch.exp2(k[:keys] @ qt.T * scale2
                                              - lse2[h, q0:q0 + bn]), 0.0)
            dst = pt * (v[:keys] @ dot.T - delta[h, q0:q0 + bn])
            dv[:keys] += _bf16(pt) @ dot
            dk[:keys] += _bf16(dst) @ qt
    scale = 1.0 / math.sqrt(D)
    return dq.transpose(0, 1) * scale, dk * scale, dv


@pytest.mark.parametrize("S,G,D,causal", [
    (4096, 4, 128, True),    # one kv head of granite's training shape
    (1500, 1, 64, False),    # one head of whisper's encoder
])
def test_backward_bf16_wgmma_tiles_meet_phase_2b(S, G, D, causal):
    """The bf16 backward on wgmma (``attn_dq_kernel_wgmma``,
    ``attn_dkv_kernel_wgmma``) at its tiles, 64 keys a B3 step and 64
    queries a B4 step, with p and ds rounded once to bf16 and dQ, dK, dV
    accumulated directly: dq, dk and dv stay within phase 2b's bf16
    tolerance (``chip_smoke.TOL``, max abs error over the largest
    magnitude) of the plain f32 backward on the same bf16 inputs."""
    tol = _smoke().TOL["bfloat16"]
    rng = np.random.default_rng(S + D)
    q, do = (_bf16(_rand(rng, (1, S, G, D))) for _ in range(2))
    k, v = (_bf16(_rand(rng, (1, S, 1, D))) for _ in range(2))
    o, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal)
    delta = ref.attention_delta(o, do)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    got = _bwd_wgmma_tiles(q[0], k[0, :, 0], v[0, :, 0], do[0], lse[0],
                           delta[0], causal)
    rel = [float((g - w[0].reshape(g.shape)).abs().max()
                 / w.abs().max()) for g, w in zip(got, want)]
    print(f"S{S} G{G} D{D} causal={causal}: rel err dq, dk, dv {rel}")
    assert max(rel) <= tol
    assert min(rel) > 0       # p and ds were rounded
