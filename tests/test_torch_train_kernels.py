"""The training path's kernel entry points, on the CPU, against the JAX
package's Pallas kernels (interpret mode) and its differentiable ops.

On CPU tensors :func:`repro_torch.kernels.ops.flash_attention` and
:func:`~repro_torch.kernels.ops.rmsnorm` run their kernels' plain
versions, inside the same ``torch.autograd.Function``s that launch the
kernels on the card. These tests hold the plain versions of the
forward-with-lse (B2), dq (B3) and dkv (B4) kernels to the TPU kernels,
and the gradients through both wrappers to ``jax.grad`` of the JAX
package's functions, on the same inputs made with numpy.

Tolerance: atol = rtol = 1e-5 in f32, as ``test_torch_kernels.py``: the
two sides sum in different orders (blocks vs one dense product). The
Pallas backward drops tail rows when its blocks do not tile the sequence,
so it is compared at tileable lengths only; untileable lengths are held
to autograd through the port's ``dense_attention``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jax_ops
from repro.kernels.flash_attention import (flash_attention_bwd,
                                           flash_attention_fwd)
from repro.models.layers import apply_norm as jax_apply_norm
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)
TOL = 1e-5
HEADS = [(4, 4), (8, 2), (8, 1)]


def _pair(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def _qkv(rng, S, hq, hkv, D, sk=None):
    sk = S if sk is None else sk
    return (_pair(rng, (1, S, hq, D)), _pair(rng, (1, sk, hkv, D)),
            _pair(rng, (1, sk, hkv, D)))


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("window", [0, 96])
def test_lse_forward_plain_matches_pallas(window, heads):
    hq, hkv = heads
    rng = np.random.default_rng(hq * 10 + hkv + window)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 128, hq, hkv, 32)
    o_want, lse_want = flash_attention_fwd(
        qj, kj, vj, causal=True, window=window, block_q=64, block_k=64,
        interpret=True, return_lse=True)
    o, lse = ref.flash_attention_lse_ref(qt, kt, vt, causal=True,
                                         window=window)
    assert lse.dtype == torch.float32 and lse.shape == (1, hq, 128)
    _close(o, o_want)
    _close(lse, lse_want)


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("window", [0, 96])
def test_backward_plain_matches_pallas(window, heads):
    """dq, dk, dv from the same q, k, v, o, lse and dO as the TPU
    kernels (o and lse from the JAX forward)."""
    hq, hkv = heads
    rng = np.random.default_rng(hq * 7 + hkv + window)
    S, D = 128, 32
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, S, hq, hkv, D)
    doj, dot = _pair(rng, (1, S, hq, D))
    oj, lsej = flash_attention_fwd(qj, kj, vj, causal=True, window=window,
                                   block_q=64, block_k=64, interpret=True,
                                   return_lse=True)
    want = flash_attention_bwd(qj, kj, vj, oj, lsej, doj, causal=True,
                               window=window, block_q=64, block_k=64,
                               interpret=True)
    got = ref.flash_attention_bwd_ref(
        qt, kt, vt, torch.from_numpy(np.array(oj)),
        torch.from_numpy(np.array(lsej)), dot, causal=True, window=window)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("window", [0, 96])
def test_flash_attention_grads_match_jax(window, heads):
    """torch.autograd through ops.flash_attention (the autograd Function
    that launches B2, B3 and B4 on the card) against jax.grad of the JAX
    package's custom_vjp flash attention, for loss = sum(o * w)."""
    hq, hkv = heads
    rng = np.random.default_rng(hq * 3 + hkv + window)
    S, D = 128, 32
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, S, hq, hkv, D)
    wj, wt = _pair(rng, (1, S, hq, D))

    def jloss(q, k, v):
        return jnp.sum(jax_ops.flash_attention(q, k, v, causal=True,
                                               window=window) * wj)

    want = jax.grad(jloss, argnums=(0, 1, 2))(qj, kj, vj)
    q, k, v = (t.clone().requires_grad_() for t in (qt, kt, vt))
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * wt).sum(), (q, k, v))
    assert ops.LAUNCHES == before          # the CPU launches no kernel
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("sq,sk,hq,hkv,window", [
    (100, 100, 8, 2, 0), (77, 77, 4, 4, 40), (50, 77, 8, 1, 0)])
def test_flash_attention_grads_untileable_lengths(sq, sk, hq, hkv, window):
    """The port's backward takes any length: against autograd through the
    plain dense attention."""
    rng = np.random.default_rng(sq + sk + hq)
    (_, qt), (_, kt), (_, vt) = _qkv(rng, sq, hq, hkv, 16, sk=sk)
    wt = torch.from_numpy(rng.standard_normal((1, sq, hq, 16))
                          .astype(np.float32))
    q1, k1, v1 = (t.clone().requires_grad_() for t in (qt, kt, vt))
    q2, k2, v2 = (t.clone().requires_grad_() for t in (qt, kt, vt))
    got = torch.autograd.grad(
        (ops.flash_attention(q1, k1, v1, causal=True, window=window)
         * wt).sum(), (q1, k1, v1))
    want = torch.autograd.grad(
        (ref.dense_attention(q2, k2, v2, causal=True, window=window)
         * wt).sum(), (q2, k2, v2))
    for g, w in zip(got, want):
        _close(g, w.numpy())


@pytest.mark.parametrize("shape", [(2, 5, 64), (17, 256)])
def test_rmsnorm_grads_match_jax(shape):
    rng = np.random.default_rng(shape[-1] + len(shape))
    xj, xt = _pair(rng, shape)
    sj, st = _pair(rng, (shape[-1],))
    wj, wt = _pair(rng, shape)

    def jloss(x, s):
        return jnp.sum(jax_apply_norm({"scale": s}, x, "rmsnorm") * wj)

    want = jax.grad(jloss, argnums=(0, 1))(xj, sj)
    x, s = xt.clone().requires_grad_(), st.clone().requires_grad_()
    out = ops.rmsnorm(x, s)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * wt).sum(), (x, s))
    for g, w in zip(got, want):
        _close(g, w)


def test_no_grad_calls_take_the_forward_only_path():
    """Without a gradient to record, the wrappers hand back plain outputs
    (on the card: K1 and K3 alone)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 16))
                         .astype(np.float32)).requires_grad_()
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).grad_fn is None
        assert ops.rmsnorm(q, torch.ones(16)).grad_fn is None
    assert ops.flash_attention(q.detach(), q.detach(),
                               q.detach()).grad_fn is None
