"""The port's dense model against the JAX package's, from the same
parameters (JAX's init, through :func:`repro_torch.bridge.params_from_jax`)
and the same token inputs (numpy, seeded).

Reduced ``granite-3-8b`` (GQA, RMSNorm, tied vocab), ``qwen2.5-32b``
(``qkv_bias``), ``stablelm-12b`` (LayerNorm) and ``qwen1.5-110b``
(``qkv_bias``, rope theta 1e6, untied vocab), each with the port's
``dense`` and ``kernel`` attention backends (on the CPU the kernel backend
runs the kernels' plain versions). Tolerance 1e-4: the two frameworks sum
in different orders and the error accumulates over layers.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch, reduced
from repro.models import Runtime as JaxRuntime
from repro.models import build as jax_build
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch as torch_get_arch
from repro_torch.configs import reduced as torch_reduced
from repro_torch.models import Runtime, build

torch.set_num_threads(2)
TOL = 1e-4
ARCHS = ["granite-3-8b", "qwen2.5-32b", "stablelm-12b", "qwen1.5-110b"]
B, PROMPT, SPAN = 2, 12, 24


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _models(arch, backend):
    jcfg = reduced(get_arch(arch))
    jm = jax_build(jcfg, JaxRuntime(attention_backend="dense"),
                   param_dtype=jnp.float32)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    cfg = torch_reduced(torch_get_arch(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)  # the copy
    tm = build(cfg, Runtime(attention_backend=backend), device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jm, jparams, tm, tparams


def _tokens(cfg_vocab, shape, seed):
    return np.random.default_rng(seed).integers(1, cfg_vocab, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("backend", ["dense", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, backend):
    jm, jp, tm, tp = _models(arch, backend)
    toks = _tokens(tm.cfg.vocab_size, (B, PROMPT), 0)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, SPAN)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, SPAN)
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["layers"][name], jc["layers"][name])
    # 4 decode steps with per-row positions (continuous batching)
    for i in range(4):
        step_toks = _tokens(tm.cfg.vocab_size, (B, 1), 10 + i)
        pos = np.array([PROMPT + i, PROMPT + 3 + i], np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(step_toks),
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(step_toks),
                                torch.from_numpy(pos))
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["layers"][name], jc["layers"][name])


@pytest.mark.parametrize("backend", ["dense", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_and_paged_decode_match_jax(arch, backend):
    """Two prefill chunks into the page pool (the second's history is
    n_live * page_size > chunk keys), then two paged decode steps."""
    jm, jp, tm, tp = _models(arch, backend)
    ps, npag, num_pages = 4, 5, 12
    toks = _tokens(tm.cfg.vocab_size, (B, PROMPT), 1)
    btab = np.array([[3, 7, 1, 0, 0], [2, 9, 11, 5, 0]], np.int32)
    jc = jm.paged_cache_init(num_pages, ps)
    tc = tm.paged_cache_init(num_pages, ps)
    for lo, hi in ((0, 8), (8, PROMPT)):
        n_live = -(-hi // ps)
        jl, jc = jm.prefill_chunk(jp, jc, jnp.asarray(toks[:, lo:hi]),
                                  jnp.asarray(btab[:, :n_live]), lo)
        tl, tc = tm.prefill_chunk(tp, tc, torch.from_numpy(toks[:, lo:hi]),
                                  torch.from_numpy(btab[:, :n_live]), lo)
        _close(tl, jl)
    for i in range(2):
        step_toks = _tokens(tm.cfg.vocab_size, (B, 1), 20 + i)
        pos = np.array([PROMPT + i, PROMPT + i], np.int32)
        jl, jc = jm.decode_step_paged(jp, jc, jnp.asarray(step_toks),
                                      jnp.asarray(pos), jnp.asarray(btab))
        tl, tc = tm.decode_step_paged(tp, tc, torch.from_numpy(step_toks),
                                      torch.from_numpy(pos),
                                      torch.from_numpy(btab))
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["layers"][name], jc["layers"][name])


def test_port_params_have_the_jax_layout():
    """The port's own init draws a tree with the JAX tree's names, shapes
    and dtypes, so the bridge needs no transposes."""
    jm, jp, tm, tp = _models("qwen2.5-32b", "kernel")
    own = tm.init_params(torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node = own
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
