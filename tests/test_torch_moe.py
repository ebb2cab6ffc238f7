"""The port's MoE FFN (``models/moe.py``) against the JAX package's
one-device dispatch (``repro/models/moe.py::_moe_ffn_dense``), from the
same parameters (JAX's init through the bridge) and the same inputs
(numpy, seeded): the output, ``aux_loss``, ``expert_load``, ``capacity``
and the gradients, for reduced arctic-480b (top-2, a dense residual MLP)
and llama4-maverick (top-1), with and without dropped tokens. Also the
capacity rule and the ``load_balance/moe`` record.

Tolerance 1e-4, as ``tests/test_torch_model.py`` (the frameworks sum in
different orders, and the skewed inputs give outputs near 20, where f32
rounds at 2e-6); the routing decisions, hence ``expert_load``, equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import moe as jax_moe
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch, reduced
from repro_torch.models import moe

torch.set_num_threads(2)
TOL = 1e-4
ARCHS = ["arctic-480b", "llama4-maverick-400b-a17b"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _setup(arch, skew: float, experts: int = 4, seed: int = 0):
    """The JAX block's params and an input (2, 24, d); ``skew`` > 0 adds a
    shared direction to every token that most routers send to the same
    experts, so their segments overflow the capacity."""
    jcfg = jax_reduced(jax_get_arch(arch), experts=experts)
    cfg = reduced(get_arch(arch), experts=experts)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    x += skew * rng.standard_normal(cfg.d_model).astype(np.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, cfg, tp, x


@pytest.mark.parametrize("skew", [0.0, 3.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, skew):
    jcfg, jp, cfg, tp, x = _setup(arch, skew)
    jy, jaux = jax_moe._moe_ffn_dense(jp, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_ffn(tp, torch.from_numpy(x), cfg)
    _close(ty, jy)
    _close(taux["aux_loss"], jaux["aux_loss"])
    np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                  np.asarray(jaux["expert_load"]))
    assert taux["capacity"] == jaux["capacity"]
    if skew:    # the skewed router fills an expert and drops tokens
        load = taux["expert_load"]
        pairs = x.shape[0] * x.shape[1] * cfg.moe.top_k
        assert float(load.max()) == taux["capacity"]
        assert float(load.sum()) <= pairs - 8


def _torch_grads(tp, x, cfg, w, with_y: bool):
    tparams = {k: (v.clone().requires_grad_() if torch.is_tensor(v)
                   else {kk: vv.clone().requires_grad_()
                         for kk, vv in v.items()})
               for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_ffn(tparams, tx, cfg)
    loss = aux["aux_loss"]
    if with_y:
        loss = loss + (y * torch.from_numpy(w)).sum()
    loss.backward()
    return tparams, tx.grad


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_grads_match_jax(arch):
    """Gradients of sum(y * w) + aux_loss in every parameter and the input
    (arctic with dropped tokens: the skewed router), and of aux_loss
    alone in the router. With top-1 (llama4) the router's gradient of
    sum(y * w) is zero in exact arithmetic (the gate is g / g) and only
    rounding noise in either framework, so its router is held on
    aux_loss alone."""
    jcfg, jp, cfg, tp, x = _setup(arch, 3.0, seed=1)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx, with_y):
        y, aux = jax_moe._moe_ffn_dense(p, xx, jcfg)
        return aux["aux_loss"] + (jnp.sum(y * w) if with_y else 0.0)

    for with_y in (True, False):
        jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x), with_y)
        tparams, tgx = _torch_grads(tp, x, cfg, w, with_y)
        if with_y:
            _close(tgx, jgx)
        for path, want in jax.tree_util.tree_flatten_with_path(jg)[0]:
            names = [key.key for key in path]
            noise = names == ["router"] and cfg.moe.top_k == 1
            if noise == with_y:   # with y: all but noise; without: noise
                continue
            node = tparams
            for key in names:
                node = node[key]
            _close(node.grad, want)


@pytest.mark.parametrize("tokens", [1, 4, 16, 48, 128, 1000, 4096])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch, tokens):
    for experts in (4, 128):
        jcfg = jax_reduced(jax_get_arch(arch), experts=experts)
        cfg = reduced(get_arch(arch), experts=experts)
        assert moe.capacity(tokens, cfg.moe) == \
            jax_moe.capacity(tokens, jcfg.moe)
    assert moe.capacity(tokens, get_arch(arch).moe) == \
        jax_moe.capacity(tokens, jax_get_arch(arch).moe)


def test_load_balance_moe_record_equals_the_reference():
    """``load_balance/moe``: the reference's workload and record name, and
    its LI on the reference's own block and input (numpy, through the
    bridge); the port's own run on the CPU gives an LI in (0, 1]."""
    import benchmarks.bench_load_balance  # noqa: F401  (JAX registry)
    import repro_torch.bench.suites  # noqa: F401
    from repro.bench.scenario import REGISTRY as JAX_REGISTRY
    from repro_torch.bench.scenario import REGISTRY
    from repro_torch.bench.suites.load_balance import moe_expert_load
    from repro_torch.core import metrics

    name = "load_balance/moe"
    jscen, scen = JAX_REGISTRY[name], REGISTRY[name]
    assert scen.tags == jscen.tags
    assert [(w.label, w.arch, dict(w.knobs)) for w in scen.workloads] == \
        [(w.label, w.arch, dict(w.knobs)) for w in jscen.workloads]
    (want,) = list(jscen.fn(jscen.workloads[0]))
    # the reference's own block and input
    wl = jscen.workloads[0]
    jcfg = jax_reduced(jax_get_arch(wl.arch), experts=wl.knobs["experts"])
    jp = jax_moe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    jx = jax.random.normal(jax.random.PRNGKey(1), (8, 64, jcfg.d_model)) * 0.1
    cfg = reduced(get_arch(wl.arch), experts=wl.knobs["experts"])
    load = moe_expert_load(cfg, params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu"), torch.from_numpy(
        np.asarray(jx)))
    np.testing.assert_array_equal(
        load.numpy(), np.asarray(jax_moe._moe_ffn_dense(jp, jx, jcfg)[1][
            "expert_load"]))
    assert round(float(metrics.expert_load_imbalance(load.numpy())), 4) == \
        want.derived["LI"]
    wl_cpu = dataclasses.replace(scen.workloads[0],
                                 knobs={**scen.workloads[0].knobs,
                                        "device": "cpu"})
    (got,) = list(scen.fn(wl_cpu))
    assert got.name == want.name == "load_balance/moe_experts/measured"
    assert set(got.derived) == set(want.derived) == {"LI"}
    assert 0.0 < got.derived["LI"] <= 1.0
