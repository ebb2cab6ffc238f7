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
