"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX
package's (``repro.optim.adamw``), on the same parameters and gradients
made with numpy.

Three steps with global-norm clipping active (every gradient's norm is
above ``grad_clip``), for each moment storage type and with and without
the f32 master copy; the parameter tree mixes stacked (L, d) leaves, a 1-D
leaf (no weight decay) and a leaf whose last dim does not split into
16-element blocks (int8 state keeps it f32). Tolerance 1e-5 (atol and
rtol) in f32: the two frameworks round the same f32 arithmetic in other
orders; the int8 moments are compared after decoding.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import adamw as jax_adamw
from repro_torch.bridge import params_from_jax
from repro_torch.optim import adamw

TOL = 1e-5
SHAPES = {"embed": {"tok": (24, 32)},
          "layers": {"norm1": {"scale": (2, 32)}, "w": (2, 32, 48)},
          "final_norm": {"scale": (32,)},
          "odd": (3, 5)}


def _tree(rng, shapes, std=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, std) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * std).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _decoded(tree, decode):
    return [np.asarray(decode(leaf)) for leaf in
            jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
                x, (jax_adamw.Q8, adamw.Q8)))]


@pytest.mark.parametrize("use_master", [True, False])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_three_steps_match_jax(state_dtype, use_master):
    rng = np.random.default_rng(7)
    params_np = _tree(rng, SHAPES)
    kw = dict(weight_decay=0.1, grad_clip=1.0, state_dtype=state_dtype,
              use_master=use_master)
    jopt = jax_adamw.AdamW(lr_fn=jax_adamw.warmup_cosine(1e-2, 2, 10), **kw)
    topt = adamw.AdamW(lr_fn=adamw.warmup_cosine(1e-2, 2, 10), **kw)
    jp = jax.tree.map(jnp.asarray, params_np)
    tp = params_from_jax(params_np, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        grads = _tree(rng, SHAPES, std=3.0)
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tp2, ts2, tm = topt.update(params_from_jax(grads, "cpu"), ts, tp)
        assert tp2 is tp and ts2 is ts               # updated in place
        assert float(tm["grad_norm"]) > topt.grad_clip   # clipping active
        _close(float(tm["grad_norm"]), float(jm["grad_norm"]))
        _close(tm["lr"], float(jm["lr"]))
        assert ts.step == int(js.step) == step + 1
        for got, want in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
            _close(got, want)
        for name in ("m", "v"):
            _close(np.concatenate([a.ravel() for a in _decoded(
                       getattr(ts, name), adamw._q8_decode)]),
                   np.concatenate([a.ravel() for a in _decoded(
                       getattr(js, name), jax_adamw._q8_decode)]))
        if use_master:
            for got, want in zip(jax.tree.leaves(ts.master),
                                 jax.tree.leaves(js.master)):
                _close(got, want)
        else:
            assert ts.master == {}


def test_int8_state_layout_matches_jax():
    """Q8 where the last dim splits into 16-element blocks, f32 elsewhere,
    with the reference's shapes."""
    rng = np.random.default_rng(3)
    params_np = _tree(rng, SHAPES)
    js = jax_adamw.AdamW(lr_fn=lambda s: 1e-3,
                         state_dtype="int8").init(
        jax.tree.map(jnp.asarray, params_np))
    ts = adamw.AdamW(lr_fn=lambda s: 1e-3, state_dtype="int8").init(
        params_from_jax(params_np, "cpu"))
    is_q8 = lambda x: isinstance(x, (jax_adamw.Q8, adamw.Q8))  # noqa: E731
    for got, want in zip(jax.tree.leaves(ts.m, is_leaf=is_q8),
                         jax.tree.leaves(js.m, is_leaf=is_q8)):
        assert isinstance(got, adamw.Q8) == isinstance(want, jax_adamw.Q8)
        if isinstance(got, adamw.Q8):
            assert got.q.dtype == torch.int8
            assert tuple(got.q.shape) == want.q.shape
            assert tuple(got.scale.shape) == want.scale.shape
        else:
            assert got.dtype == torch.float32


@pytest.mark.parametrize("step", [0, 1, 2, 5, 6, 50, 99, 100, 150])
def test_warmup_cosine_matches_jax(step):
    want = jax_adamw.warmup_cosine(3e-4, 5, 100)(jnp.asarray(step))
    got = adamw.warmup_cosine(3e-4, 5, 100)(step)
    np.testing.assert_allclose(got, float(want), rtol=1e-6, atol=0)


def test_global_norm_matches_jax():
    grads = _tree(np.random.default_rng(5), SHAPES)
    want = jax_adamw.global_norm(jax.tree.map(jnp.asarray, grads))
    got = adamw.global_norm(params_from_jax(grads, "cpu"))
    _close(float(got), float(want))
