"""Kernel B6's plain version (``repro_torch.kernels.ref.wkv6_chunked_ref``)
against the JAX package's WKV6 (``repro.kernels.ops.wkv6``, which runs
the Pallas kernel in interpret mode on the CPU), and the port's checked
entry point ``ops.wkv6`` on CPU tensors.

Inputs are numpy, seeded. Both intra-chunk branches are covered: a mild
decay keeps every chunk's range -min(cumsum(ld)) under SAFE_DECAY_RANGE
(the rescaled product), a strong one puts every chunk past it (the exact
per-pair fallback); each test asserts which. Errors are measured as the
max abs difference over the reference's max magnitude (as
``chip_smoke.py`` measures the kernel): the fallback's per-pair exponent
e^{w_t - p_s} takes the difference of two cumulative sums of up to ~64,
whose last-bit rounding the two frameworks' cumsums place differently,
so an elementwise relative bound would be set by the smallest outputs.
Tolerances: 1e-5 in f32, 2e-2 in bf16 (``tests/test_kernels.py::_tol``'s
bf16 bound), and 1e-3 elementwise against the exact recurrence, as
``tests/test_kernels.py`` holds the Pallas kernel.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# per-token decay magnitudes (uniform) that keep every chunk of the given
# length under the range bound (mild) or put every chunk past it (strong)
REGIMES = {("mild", 16): (0.001, 0.2), ("mild", 64): (0.001, 0.2),
           ("strong", 16): (2.0, 4.0), ("strong", 64): (0.5, 1.0)}


def _inputs(seed, B, T, H, K, V, mode, regime, chunk, state=False):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, T, H, K)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, T, H, V)).astype(np.float32)
    lo, hi = REGIMES[regime, chunk]
    ld = -rng.uniform(lo, hi, (B, T, H, K)).astype(np.float32)
    u = (rng.standard_normal((H, K)).astype(np.float32) * 0.5
         if mode == "rwkv6" else None)
    s0 = (rng.standard_normal((B, H, K, V)).astype(np.float32)
          if state else None)
    return q, k, v, ld, u, s0


def _assert_branch(ld, chunk, regime):
    """Every chunk (the last one whole or not) on the regime's side of the
    range bound."""
    T = ld.shape[1]
    ranges = [-np.cumsum(ld[:, i:i + chunk], axis=1).min(axis=(1, 3))
              for i in range(0, T, chunk)]
    mild = all((r < ref.SAFE_DECAY_RANGE).all() for r in ranges)
    strong = all((r >= ref.SAFE_DECAY_RANGE).all() for r in ranges)
    assert mild if regime == "mild" else strong


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax(arrays, chunk, dtype=jnp.float32):
    q, k, v, ld, u, s0 = arrays
    opt = (lambda a: None if a is None else jnp.asarray(a))
    return jax_ops.wkv6(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                        jnp.asarray(ld), opt(u), opt(s0), chunk=chunk)


def _torch(arrays, chunk, dtype=torch.float32):
    q, k, v, ld, u, s0 = arrays
    opt = (lambda a: None if a is None else torch.from_numpy(a))
    return ref.wkv6_chunked_ref(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
        torch.from_numpy(ld), opt(u), opt(s0), chunk=chunk)


@pytest.mark.parametrize("regime", ["mild", "strong"])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("kv", [(16, 64), (64, 32)])
@pytest.mark.parametrize("mode", ["rwkv6", "ssd"])
def test_chunked_ref_matches_pallas(mode, kv, chunk, regime):
    K, V = kv
    arrays = _inputs(K + V + chunk, 2, 128, 2, K, V, mode, regime, chunk)
    _assert_branch(arrays[3], chunk, regime)
    (jo, js), (to, ts) = _jax(arrays, chunk), _torch(arrays, chunk)
    assert to.dtype == torch.float32 and ts.dtype == torch.float32
    assert _rel_err(to, jo) <= TOL["float32"]
    assert _rel_err(ts, js) <= TOL["float32"]


@pytest.mark.parametrize("regime", ["mild", "strong"])
@pytest.mark.parametrize("mode", ["rwkv6", "ssd"])
def test_chunked_ref_folds_initial_state_as_pallas_wrapper(mode, regime):
    arrays = _inputs(7, 2, 128, 3, 16, 64, mode, regime, 64, state=True)
    _assert_branch(arrays[3], 64, regime)
    (jo, js), (to, ts) = _jax(arrays, 64), _torch(arrays, 64)
    assert _rel_err(to, jo) <= TOL["float32"]
    assert _rel_err(ts, js) <= TOL["float32"]


@pytest.mark.parametrize("regime", ["mild", "strong"])
@pytest.mark.parametrize("mode", ["rwkv6", "ssd"])
def test_chunked_ref_bf16_matches_pallas(mode, regime):
    arrays = _inputs(11, 1, 128, 2, 64, 64, mode, regime, 64)
    jo, js = _jax(arrays, 64, jnp.bfloat16)
    to, ts = _torch(arrays, 64, torch.bfloat16)
    assert to.dtype == torch.bfloat16 and ts.dtype == torch.float32
    assert _rel_err(to.float(), np.asarray(jo, np.float32)) \
        <= TOL["bfloat16"]
    assert _rel_err(ts, js) <= TOL["bfloat16"]


@pytest.mark.parametrize("regime", ["mild", "strong"])
@pytest.mark.parametrize("mode", ["rwkv6", "ssd"])
@pytest.mark.parametrize("T", [75, 5])
def test_chunked_ref_takes_any_length(T, mode, regime):
    """T = 75 (a ragged second chunk) and 5 (one short chunk); the Pallas
    kernel raises unless the chunk tiles T, so the exact recurrence of
    the JAX package is the reference here."""
    arrays = _inputs(T, 2, T, 2, 16, 32, mode, regime, 64)
    q, k, v, ld, u, _ = arrays
    to, ts = _torch(arrays, 64)
    assert to.shape == (2, T, 2, 32)
    wo, ws = jax_ref.wkv6_ref(*(jnp.asarray(a) for a in (q, k, v, ld)),
                              None if u is None else jnp.asarray(u))
    np.testing.assert_allclose(to.numpy(), np.asarray(wo), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ws), atol=1e-3,
                               rtol=1e-3)


def test_exact_recurrence_matches_jax():
    arrays = _inputs(3, 2, 40, 2, 16, 32, "rwkv6", "strong", 16)
    q, k, v, ld, u, _ = arrays
    for uu in (u, None):
        to, ts = ref.wkv6_ref(*(torch.from_numpy(a) for a in (q, k, v, ld)),
                              None if uu is None else torch.from_numpy(uu))
        wo, ws = jax_ref.wkv6_ref(*(jnp.asarray(a) for a in (q, k, v, ld)),
                                  None if uu is None else jnp.asarray(uu))
        np.testing.assert_allclose(to.numpy(), np.asarray(wo), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(ws), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("mode", ["rwkv6", "ssd"])
def test_ops_wkv6_on_cpu_runs_the_plain_version(mode):
    arrays = _inputs(5, 2, 70, 2, 16, 32, mode, "mild", 64, state=True)
    q, k, v, ld, u, s0 = (None if a is None else torch.from_numpy(a)
                          for a in arrays)
    before = dict(ops.LAUNCHES)
    o, s = ops.wkv6(q, k, v, ld, u, s0)
    assert ops.LAUNCHES == before       # no kernel on CPU tensors
    want_o, want_s = ref.wkv6_chunked_ref(q, k, v, ld, u, s0)
    assert torch.equal(o, want_o) and torch.equal(s, want_s)
    # SSD's per-head decay arrives as a broadcast view (stride 0 along K)
    ld_head = ld[..., :1].expand(ld.shape)
    o2, _ = ops.wkv6(q, k, v, ld_head, u)
    assert torch.equal(o2, ref.wkv6_chunked_ref(q, k, v,
                                                ld_head.contiguous(), u)[0])


@pytest.mark.parametrize("regime", ["mild", "strong"])
@pytest.mark.parametrize("mode", ["rwkv6", "ssd"])
def test_ops_wkv6_on_cpu_is_differentiable(mode, regime):
    """On CPU tensors that require grad the plain version carries the
    gradient (finite in both branches) and agrees with autograd through
    the exact recurrence."""
    arrays = _inputs(9, 1, 40, 2, 16, 16, mode, regime, 64)
    leaves = [torch.from_numpy(a).requires_grad_()
              if a is not None else None for a in arrays[:5]]
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 40, 2, 16)).astype(np.float32))
    got = torch.autograd.grad((ops.wkv6(*leaves)[0] * w).sum(),
                              [t for t in leaves if t is not None])
    want = torch.autograd.grad((ref.wkv6_ref(*leaves)[0] * w).sum(),
                               [t for t in leaves if t is not None])
    for g, e in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel_err(g.numpy(), e.numpy()) <= 1e-4


def test_ops_wkv6_rejects_bad_arguments():
    q = torch.zeros(1, 8, 2, 16)
    v = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="bad shapes"):
        ops.wkv6(q, q, v, q[:, :4])
    with pytest.raises(ValueError, match="dtypes"):
        ops.wkv6(q, q.double(), v, q)
    with pytest.raises(ValueError, match="u must be"):
        ops.wkv6(q, q, v, q, torch.zeros(2, 8))
    with pytest.raises(ValueError, match="initial_state"):
        ops.wkv6(q, q, v, q, None, torch.zeros(1, 2, 16, 16))


# ------------------------------------------------- B6's algorithm on the card
# An emulation in PyTorch of what csrc/wkv6.cu computes (f32): chunks of 64
# cut into four 16-row sub-blocks, the scores of an off-diagonal pair (i > j)
# rescaled against the end of sub-block j (both operands <= 1), a diagonal
# sub-block rescaled about its row 8 while each half spans a decay range
# below SAFE_DECAY_RANGE and exact per pair otherwise, and the state path
# from the same scaled operands. It lives here, not in the package: the
# package's plain version stays the reference's per-chunk branch.
SUB = 16


def _subblock_wkv6(q, k, v, ld, u=None, chunk: int = 64):
    """(o, state, exact) for f32 (B, T, H, *) tensors with T a multiple of
    the chunk; ``exact`` counts the diagonal sub-blocks (per b, h, chunk)
    that took the per-pair exponent."""
    B, T, H, K = q.shape
    V = v.shape[-1]
    q, k, v, ld = (a.transpose(1, 2) for a in (q, k, v, ld))  # (B, H, T, *)
    S = torch.zeros((B, H, K, V))
    outs, exact = [], 0
    nsub = chunk // SUB
    for c0 in range(0, T, chunk):
        qc, kc, vc, lc = (a[:, :, c0:c0 + chunk] for a in (q, k, v, ld))
        p = torch.cumsum(lc, dim=2)
        w = p - lc if u is not None else p
        r_end = p[:, :, SUB - 1::SUB]                          # (B, H, 4, K)
        r_start = torch.cat([torch.zeros_like(r_end[:, :, :1]),
                             r_end[:, :, :-1]], dim=2)
        mid = p[:, :, SUB // 2 - 1::SUB]
        blk = torch.arange(chunk) // SUB
        qh = qc * torch.exp(w - r_start[:, :, blk])
        kh = kc * torch.exp(r_end[:, :, blk] - p)
        A = torch.zeros((B, H, chunk, chunk))
        rows = torch.arange(SUB)
        keep = (rows[:, None] > rows[None, :]) if u is not None else (
            rows[:, None] >= rows[None, :])
        for i in range(nsub):
            ti = slice(SUB * i, SUB * (i + 1))
            for j in range(i):
                tj = slice(SUB * j, SUB * (j + 1))
                f = torch.exp(r_start[:, :, i] - r_end[:, :, j])[:, :, None]
                A[:, :, ti, tj] = (qh[:, :, ti] * f) @ kh[:, :, tj].transpose(-1, -2)
            fq = torch.exp(r_start[:, :, i] - mid[:, :, i])[:, :, None]
            fk = torch.exp(mid[:, :, i] - r_end[:, :, i])[:, :, None]
            resc = (qh[:, :, ti] * fq) @ (kh[:, :, ti] * fk).transpose(-1, -2)
            diff = (w[:, :, ti, None] - p[:, :, None, ti]).masked_fill(
                ~keep[None, None, :, :, None], float("-inf"))
            pair = torch.einsum("bhtk,bhsk,bhtsk->bhts", qc[:, :, ti],
                                kc[:, :, ti], torch.exp(diff))
            safe = ((r_start[:, :, i] - mid[:, :, i]).amax(-1)
                    < ref.SAFE_DECAY_RANGE) & (
                (mid[:, :, i] - r_end[:, :, i]).amax(-1)
                < ref.SAFE_DECAY_RANGE)                          # (B, H)
            exact += int((~safe).sum())
            A[:, :, ti, ti] = torch.where(safe[..., None, None],
                                          resc.masked_fill(~keep, 0.0), pair)
        o = A @ vc
        if u is not None:
            o = o + torch.einsum("bhtk,hk,bhtk->bht", qc, u, kc)[..., None] * vc
        o = o + (qh * torch.exp(r_start[:, :, blk])) @ S
        kd = kh * torch.exp(r_end[:, :, -1:] - r_end[:, :, blk])
        S = torch.exp(p[:, :, -1])[..., None] * S + kd.transpose(-1, -2) @ vc
        outs.append(o)
    return torch.cat(outs, 2).transpose(1, 2), S, exact


# per-token decay magnitudes: mild (every range small), hymba's SSD decay of
# about 0.7 a token (past the range bound per chunk, under it per half
# sub-block), and a strong one: the mild decay with 6-12 a token on the last
# 16 rows of every chunk, a sub-block spanning more than 88. (6-12 on every
# row would put |p| near 600 by a chunk's end, where p's own f32 rounding
# moves rwkv6's undecayed neighbour term e^{w_t - p_(t-1)} by ~3e-5: the JAX
# package's Pallas kernel and its exact recurrence then differ by 1.8e-5.
# The card tests hold the kernel to its plain version at that decay.)
SUB_REGIMES = {"mild": (0.001, 0.2), "hymba": (0.5, 0.9),
               "strong": (0.001, 0.2)}
STRONG_BURST = (6.0, 12.0)


@pytest.mark.parametrize("regime", ["mild", "hymba", "strong"])
@pytest.mark.parametrize("mode", ["rwkv6", "ssd"])
def test_subblock_algorithm_matches_jax(mode, regime):
    """B6's sub-block rescaling against the JAX package's exact recurrence
    (``repro.kernels.ref.wkv6_ref``) and its Pallas kernel in interpret
    mode, with f32 inputs from a seed: finite everywhere, within 1e-5 of
    the reference's max magnitude (TOL["float32"]; the same measure as
    the tests above)."""
    from repro.kernels.rwkv6 import wkv6_fwd
    B, T, H, K, V = 1, 128, 2, 32, 16
    rng = np.random.default_rng(len(mode) + 10 * len(regime))
    q, k = (rng.standard_normal((B, T, H, K)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, T, H, V)).astype(np.float32)
    lo, hi = SUB_REGIMES[regime]
    ld = -rng.uniform(lo, hi, (B, T, H, K)).astype(np.float32)
    if regime == "strong":
        burst = np.arange(T) % 64 >= 64 - SUB
        ld[:, burst] = -rng.uniform(*STRONG_BURST, (B, int(burst.sum()), H, K))
    u = (rng.standard_normal((H, K)).astype(np.float32) * 0.5
         if mode == "rwkv6" else None)
    p = np.cumsum(ld.reshape(B, T // 64, 64, H, K), axis=2)
    chunk_range = -p.min(axis=(2, 4))
    sub = p.reshape(B, T // 64, 4, SUB, H, K)
    sub_range = (np.concatenate([np.zeros_like(sub[:, :, :1, -1]),
                                 sub[:, :, :-1, -1]], axis=2)
                 - sub[:, :, :, -1]).max(axis=-1)
    if regime == "mild":
        assert (chunk_range < ref.SAFE_DECAY_RANGE).all()
    elif regime == "hymba":
        assert (chunk_range >= ref.SAFE_DECAY_RANGE).all()
        assert (sub_range < 2 * ref.SAFE_DECAY_RANGE).all()
    else:   # e^{-p} of the reference's rescaled product overflows f32 here
        assert (sub_range > 88.0).any()
    tt = [torch.from_numpy(a) for a in (q, k, v, ld)]
    uu = None if u is None else torch.from_numpy(u)
    o, s, exact = _subblock_wkv6(*tt, uu)
    assert (exact > 0) == (regime == "strong")
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    ja = [jnp.asarray(a) for a in (q, k, v, ld)]
    ju = None if u is None else jnp.asarray(u)
    for wo, ws in (jax_ref.wkv6_ref(*ja, ju),
                   wkv6_fwd(*ja, ju, chunk=64, interpret=True)):
        assert _rel_err(o, wo) <= TOL["float32"]
        assert _rel_err(s, ws) <= TOL["float32"]
