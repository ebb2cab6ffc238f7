"""The port's kernel entry points, on the CPU, against the JAX package's
Pallas kernels (interpret mode) and references.

On CPU tensors each wrapper of :mod:`repro_torch.kernels.ops` runs its
kernel's plain PyTorch version; these tests hold those plain versions to
the TPU kernels they stand for, on the same inputs made with numpy. The
CUDA kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: atol = rtol = 1e-5 in f32 — the two sides sum in different
orders (online softmax over blocks vs one dense softmax).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.paged_attention import paged_attention_fwd
from repro.kernels.rmsnorm import rmsnorm_fwd
from repro.models.attention import dense_attention as jax_dense_attention
from repro_torch.kernels import ops

torch.set_num_threads(2)
TOL = 1e-5


def _pair(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("heads", [(4, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("window", [0, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas(causal, window, heads):
    hq, hkv = heads
    rng = np.random.default_rng(hq * 10 + hkv + window)
    S, D = 128, 32
    qj, qt = _pair(rng, (1, S, hq, D))
    kj, kt = _pair(rng, (1, S, hkv, D))
    vj, vt = _pair(rng, (1, S, hkv, D))
    want = flash_attention_fwd(qj, kj, vj, causal=causal, window=window,
                               block_q=64, block_k=64, interpret=True)
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert ops.LAUNCHES == before          # the CPU launches no kernel
    _close(got, want)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (77, 77, True, 0), (50, 77, True, 0), (100, 100, True, 40),
    (33, 33, False, 0)])
def test_flash_attention_plain_untileable_lengths(sq, sk, causal, window):
    """The Pallas kernel raises unless blocks tile the sequence; the port's
    K1 takes any length, so hold it to the JAX dense reference there."""
    rng = np.random.default_rng(sq + sk)
    qj, qt = _pair(rng, (2, sq, 8, 16))
    kj, kt = _pair(rng, (2, sk, 2, 16))
    vj, vt = _pair(rng, (2, sk, 2, 16))
    want = jax_dense_attention(qj, kj, vj, causal=causal, window=window)
    _close(ops.flash_attention(qt, kt, vt, causal=causal, window=window),
           want)


@pytest.mark.parametrize("heads", [(8, 2), (4, 4), (8, 1)])
def test_paged_attention_plain_matches_pallas(heads):
    """Ragged lengths, null-padded block tables and an all-null row (a
    retired lane)."""
    hq, hkv = heads
    rng = np.random.default_rng(hq + hkv)
    B, D, ps, npag = 4, 32, 4, 6
    P = B * npag + 1
    qj, qt = _pair(rng, (B, 1, hq, D))
    kj, kt = _pair(rng, (P, ps, hkv, D))
    vj, vt = _pair(rng, (P, ps, hkv, D))
    lengths = np.array([1, 7, npag * ps, 5], np.int32)
    perm = rng.permutation(np.arange(1, P)).reshape(B, npag)
    btab = np.zeros((B, npag), np.int32)
    for b in range(B - 1):
        live = -(-int(lengths[b]) // ps)
        btab[b, :live] = perm[b, :live]
    want = paged_attention_fwd(qj, kj, vj, jnp.asarray(btab),
                               jnp.asarray(lengths), pages_per_block=1,
                               interpret=True)
    got = ops.paged_attention(qt, kt, vt, torch.from_numpy(btab),
                              torch.from_numpy(lengths))
    _close(got, want)


@pytest.mark.parametrize("shape", [(3, 5, 64), (17, 256)])
def test_rmsnorm_plain_matches_pallas(shape):
    rng = np.random.default_rng(shape[-1])
    xj, xt = _pair(rng, shape)
    sj, st = _pair(rng, (shape[-1],))
    want = rmsnorm_fwd(xj, sj, interpret=True)
    _close(ops.rmsnorm(xt, st), want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 4, 4, 16)
    with pytest.raises(ValueError, match="dtypes"):
        ops.flash_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="does not match"):
        ops.flash_attention(q, torch.zeros(1, 4, 3, 16), torch.zeros(1, 4, 3, 16))
    pool = torch.zeros(5, 4, 4, 16)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_attention(q[:, :1], pool, pool,
                            torch.zeros(1, 2, dtype=torch.int64),
                            torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="one query token"):
        ops.paged_attention(q, pool, pool, torch.zeros(1, 2, dtype=torch.int32),
                            torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="scale"):
        ops.rmsnorm(q, torch.ones(8))


# --------------------------------------------------- K2's algorithm on the card
# An emulation in PyTorch of what csrc/paged_attention.cu computes: each row's
# live pages split over nsplit blocks (the table's width plays no part), a
# block's tokens dealt to 8 warps a stage of TK tokens at a time, each warp's
# online softmax, then the warps combined in warp order and the splits in
# split order. It lives here, not in the package.
WARPS = 8


def _combine(parts):
    """(m, l, acc) partials combined in order: m = max m_i, l = sum l_i
    e^{m_i - m}, acc likewise."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    scale = [torch.exp(p[0] - m) for p in parts]
    l = sum(p[1] * s for p, s in zip(parts, scale))
    acc = sum(p[2] * s[:, None] for p, s in zip(parts, scale))
    return m, l, acc


def _split_paged(q, kp, vp, btab, lengths, nsplit, tk):
    B, _, Hq, D = q.shape
    P, ps, Hkv, _ = kp.shape
    g, npag = Hq // Hkv, btab.shape[1]
    out = torch.zeros_like(q)
    for b in range(B):
        n = int(lengths[b])
        n_live = min(-(-n // ps), npag) if n > 0 else 0
        pps = -(-n_live // nsplit)
        for hk in range(Hkv):
            qh = q[b, 0, hk * g:(hk + 1) * g] / np.sqrt(D)
            splits = []
            for s in range(nsplit):
                pb = min(n_live, s * pps)
                tb, te = pb * ps, min(min(n_live, pb + pps) * ps, n)
                warps = []
                for w in range(WARPS):
                    m = torch.full((g,), -1e30)
                    l, acc = torch.zeros(g), torch.zeros(g, D)
                    for t0 in range(tb, te, tk):
                        toks = [t for t in range(t0 + w, t0 + tk, WARPS)
                                if t < te]
                        if not toks:
                            continue
                        phys = [int(btab[b, t // ps]) for t in toks]
                        phys = [p if 0 <= p < P else 0 for p in phys]
                        kk = torch.stack([kp[p, t % ps, hk]
                                          for p, t in zip(phys, toks)])
                        vv = torch.stack([vp[p, t % ps, hk]
                                          for p, t in zip(phys, toks)])
                        sc = qh @ kk.T
                        mx = torch.maximum(m, sc.amax(1))
                        corr, pr = torch.exp(m - mx), torch.exp(sc - mx[:, None])
                        l, acc, m = l * corr + pr.sum(1), acc * corr[:, None] + pr @ vv, mx
                    warps.append((m, l, acc))
                splits.append(_combine(warps))
            _, l, acc = _combine(splits)
            out[b, 0, hk * g:(hk + 1) * g] = acc / l.clamp(min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("tk", [32, 4])
@pytest.mark.parametrize("nsplit", range(1, 9))
def test_paged_split_combine_matches_pallas(nsplit, tk):
    """K2's split over live pages and in-launch combine, for 1-8 splits and
    the kernel's 32-token stages (head dims up to 128) or 4-token ones
    (up to 1024), against the Pallas kernel in interpret mode: a row of
    length 1, one ending on a page boundary, one filling the table, a
    retired row (all-null table), all in a table wider than most rows'
    live pages, so many splits are empty. Tolerance 1e-5 (TOL)."""
    rng = np.random.default_rng(nsplit)
    B, hq, hkv, D, ps, npag = 5, 8, 2, 32, 4, 12
    P = B * npag + 1
    qj, qt = _pair(rng, (B, 1, hq, D))
    kj, kt = _pair(rng, (P, ps, hkv, D))
    vj, vt = _pair(rng, (P, ps, hkv, D))
    lengths = np.array([1, 2 * ps, 29, npag * ps, 5], np.int32)
    perm = rng.permutation(np.arange(1, P)).reshape(B, npag)
    btab = np.zeros((B, npag), np.int32)
    for b in range(B - 1):        # the last row retired: all null pages
        live = -(-int(lengths[b]) // ps)
        btab[b, :live] = perm[b, :live]
    want = paged_attention_fwd(qj, kj, vj, jnp.asarray(btab),
                               jnp.asarray(lengths), pages_per_block=1,
                               interpret=True)
    got = _split_paged(qt, kt, vt, torch.from_numpy(btab),
                       torch.from_numpy(lengths), nsplit, tk)
    _close(got, want)


# --------------------------------------------------- K3's algorithm on the card
# An emulation in PyTorch of the order in which csrc/rmsnorm.cu sums a row's
# squares: one block per row, the row's vectors (V elements each) dealt to
# the block's threads (vector t + j * threads to thread t), each thread's
# fused multiply-adds in one chain, the lanes of a warp combined by xor
# shuffles and the warps in warp order; r = rsqrt(total / d + eps), y = x *
# r * scale.
def _xor_shuffle_sum(s):
    """(..., threads) per-thread sums -> (..., warps), each lane after
    ``s += shfl_xor(s, off)`` for off = 16..1 (lane 0's value)."""
    w = s.reshape(*s.shape[:-1], -1, 32)
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        w = w + w[..., lane ^ off]
    return w[..., 0]


def _fma_f32(acc, v):
    return (acc.double() + v.double() * v.double()).float()


def _k3_emulated(x, scale, threads, vec, eps=1e-5):
    rows, d = x.shape
    nvec = d // vec
    xv = x.reshape(rows, nvec, vec)
    acc = torch.zeros(rows, threads)
    for j in range(-(-nvec // threads)):
        idx = j * threads + torch.arange(threads)
        live = idx < nvec
        for e in range(vec):
            v = torch.where(live, xv[:, idx.clamp(max=nvec - 1), e], 0.0)
            acc = _fma_f32(acc, v)
    warps = _xor_shuffle_sum(acc)
    total = warps[:, 0]
    for w in range(1, warps.shape[-1]):
        total = total + warps[:, w]
    r = torch.rsqrt(total / d + eps)
    return x * r[:, None] * scale


# (threads, vec, d): the launches of granite's and hymba's widths in f32
# (16-byte vectors of 4) and bf16 (of 8), 16 elements a thread; a row
# held past a block's registers; ragged rows one element at a time
@pytest.mark.parametrize("threads,vec,d", [
    (256, 4, 4096), (128, 4, 1600), (256, 8, 4096), (128, 8, 1600),
    (32, 4, 4096), (288, 1, 4097), (32, 1, 100), (128, 1, 1600)])
def test_rmsnorm_block_sum_matches_pallas(threads, vec, d):
    """K3's sum of squares in the kernel's order (thread chains, xor
    shuffle, warps in order) against the Pallas kernel in interpret mode.
    Tolerance 1e-5 (TOL)."""
    rng = np.random.default_rng(d + threads)
    xj, xt = _pair(rng, (3, d))
    sj, st = _pair(rng, (d,))
    want = rmsnorm_fwd(xj, sj, interpret=True)
    _close(_k3_emulated(xt, st, threads, vec), want)
