"""The port's ssm (rwkv6) and hybrid (attention + SSD heads, sliding
window) families against the JAX package's: the linear-attention
primitives and the rwkv6 / SSD mixes of ``models/ssm.py``, the reduced
``rwkv6-3b`` and ``hymba-1.5b`` models (prefill, every cache entry,
decode at scalar and per-row positions past hymba's reduced window of
64, and the loss), and the serving engines.

Parameters come from the JAX init through
:func:`repro_torch.bridge.params_from_jax`; inputs are numpy, seeded.
Tolerances: 1e-5 for the primitives and mixes, 1e-4 for the models (the
two frameworks sum in different orders and the error accumulates over
layers), as ``tests/test_torch_model.py``; greedy tokens per rid
identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import synth_requests as jax_synth_requests
from repro.launch.serve import build_engine as jax_build_engine
from repro.models import Runtime as JaxRuntime
from repro.models import build as jax_build
from repro.models import ssm as jax_ssm
from repro.serving import SimClock as JaxSimClock
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch, reduced
from repro_torch.data.pipeline import synth_requests
from repro_torch.launch.serve import build_engine
from repro_torch.models import Runtime, build
from repro_torch.models import ssm
from repro_torch.serving import SimClock

torch.set_num_threads(2)
ARCHS = ["rwkv6-3b", "hymba-1.5b"]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------- primitives
def _la_inputs(mode, T=40, B=2, H=2, K=16, V=32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, ld = (rng.standard_normal((B, T, H, K)).astype(np.float32)
                for _ in range(3))
    v = rng.standard_normal((B, T, H, V)).astype(np.float32)
    ld = -np.exp(ld - 1.0).astype(np.float32)
    u = (rng.standard_normal((H, K)).astype(np.float32)
         if mode == "rwkv6" else None)
    s0 = rng.standard_normal((B, H, K, V)).astype(np.float32)
    return q, k, v, ld, u, s0


@pytest.mark.parametrize("variant", [("recurrent", False),
                                     ("chunked", False), ("chunked", True)])
@pytest.mark.parametrize("mode", ["rwkv6", "ssd"])
def test_linear_attention_matches_jax(mode, variant):
    """T = 40 with chunks of 16: a ragged last chunk; with a carried-in
    state."""
    backend, factored = variant
    q, k, v, ld, u, s0 = _la_inputs(mode)
    jo, js = jax_ssm.linear_attention(
        *(jnp.asarray(a) for a in (q, k, v, ld)),
        None if u is None else jnp.asarray(u), jnp.asarray(s0),
        backend=backend, chunk=16, factored=factored)
    to, ts = ssm.linear_attention(*(_t(a) for a in (q, k, v, ld, u, s0)),
                                  backend=backend, chunk=16,
                                  factored=factored)
    _close(to, jo, 1e-5)
    _close(ts, js, 1e-5)


@pytest.mark.parametrize("mode", ["rwkv6", "ssd"])
def test_linear_attention_step_matches_jax(mode):
    q, k, v, ld, u, s0 = _la_inputs(mode, T=1)
    args = [a[:, 0] for a in (q, k, v, ld)]
    js, jo = jax_ssm.linear_attention_step(
        jnp.asarray(s0), *(jnp.asarray(a) for a in args),
        None if u is None else jnp.asarray(u))
    ts, to = ssm.linear_attention_step(_t(s0), *(_t(a) for a in args), _t(u))
    _close(to, jo, 1e-5)
    _close(ts, js, 1e-5)


def _cfgs(arch):
    jcfg = jax_reduced(jax_get_arch(arch))
    cfg = reduced(get_arch(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)  # the copy
    return jcfg, cfg


@pytest.mark.parametrize("backend", ["chunked", "kernel"])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_mixes_match_jax(with_state, backend):
    jcfg, cfg = _cfgs("rwkv6-3b")
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jtm = jax_ssm.rwkv6_init(keys[0], jcfg, jnp.float32)
    jcm = jax_ssm.rwkv6_channel_mix_init(keys[1], jcfg, jnp.float32)
    tm, cm = (params_from_jax(jax.tree.map(np.asarray, p), "cpu")
              for p in (jtm, jcm))
    rng = np.random.default_rng(1)
    B, T, d = 2, 21, cfg.d_model
    H, hs = d // cfg.ssm.head_size, cfg.ssm.head_size
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    state = (rng.standard_normal((B, H, hs, hs)).astype(np.float32)
             if with_state else None)
    prev = (rng.standard_normal((B, d)).astype(np.float32)
            if with_state else None)
    opt = (lambda a: None if a is None else jnp.asarray(a))
    jout, (jst, jlast) = jax_ssm.rwkv6_time_mix(
        jtm, jnp.asarray(x), jcfg, backend="chunked", state=opt(state),
        shift_prev=opt(prev))
    tout, (tst, tlast) = ssm.rwkv6_time_mix(
        tm, _t(x), cfg, backend=backend, state=_t(state),
        shift_prev=_t(prev))
    _close(tout, jout, 1e-5)
    _close(tst, jst, 1e-5)
    _close(tlast, jlast, 0)
    jout, jlast = jax_ssm.rwkv6_channel_mix(jcm, jnp.asarray(x),
                                            shift_prev=opt(prev))
    tout, tlast = ssm.rwkv6_channel_mix(cm, _t(x), shift_prev=_t(prev))
    _close(tout, jout, 1e-5)
    _close(tlast, jlast, 0)


@pytest.mark.parametrize("backend", ["chunked", "kernel"])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_mix_matches_jax(with_state, backend):
    jcfg, cfg = _cfgs("hymba-1.5b")
    jp = jax_ssm.ssd_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    p = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    B, T, d = 2, 37, cfg.d_model
    H, hs, N = d // cfg.ssm.head_size, cfg.ssm.head_size, cfg.ssm.state_size
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    state = (rng.standard_normal((B, H, N, hs)).astype(np.float32)
             if with_state else None)
    jout, jst = jax_ssm.ssd_mix(jp, jnp.asarray(x), jcfg, backend="chunked",
                                state=None if state is None
                                else jnp.asarray(state))
    tout, tst = ssm.ssd_mix(p, _t(x), cfg, backend=backend, state=_t(state))
    _close(tout, jout, 1e-5)
    _close(tst, jst, 1e-5)


# ------------------------------------------------------------------ models
TOL = 1e-4
B, SPAN = 2, 80


def _models(arch, ssm_backend, attention_backend="kernel"):
    jcfg, cfg = _cfgs(arch)
    jm = jax_build(jcfg, JaxRuntime(attention_backend="dense"),
                   param_dtype=jnp.float32)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tm = build(cfg, Runtime(attention_backend=attention_backend,
                            ssm_backend=ssm_backend), device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jm, jparams, tm, tparams


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(1, vocab, shape,
                                                dtype=np.int32)


def _close_caches(tc, jc):
    assert set(tc["layers"]) == set(jc["layers"])
    for name, t in tc["layers"].items():
        _close(t, jc["layers"][name], TOL)


MODEL_CASES = [("rwkv6-3b", "kernel", "kernel"),
               ("rwkv6-3b", "chunked", "kernel"),
               ("hymba-1.5b", "kernel", "kernel"),
               ("hymba-1.5b", "chunked", "kernel"),
               ("hymba-1.5b", "kernel", "dense"),
               ("hymba-1.5b", "chunked", "dense")]


@pytest.mark.parametrize("prompt", [70, 30])
@pytest.mark.parametrize("arch,ssm_backend,attention", MODEL_CASES)
def test_prefill_and_decode_match_jax(arch, ssm_backend, attention, prompt):
    """A 70-token prompt overflows hymba's reduced window of 64, so the
    prefill writes a wrapped ring; a 30-token one fills it only during
    decode. Then 4 lockstep steps (scalar position) and 4 per-row steps
    (rows 3 apart), the last ones past the window."""
    jm, jp, tm, tp = _models(arch, ssm_backend, attention)
    toks = _tokens(tm.cfg.vocab_size, (B, prompt), 0)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, SPAN)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, SPAN)
    _close(tl, jl, TOL)
    _close_caches(tc, jc)
    pos = prompt + 36 if prompt == 30 else prompt   # past the window
    for i in range(8):
        step = _tokens(tm.cfg.vocab_size, (B, 1), 10 + i)
        if i < 4:
            jpos, tpos = pos + i, pos + i
        else:
            rows = np.array([pos + i, pos + 3 + i], np.int32)
            jpos, tpos = jnp.asarray(rows), torch.from_numpy(rows)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(step), jpos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(step), tpos)
        _close(tl, jl, TOL)
    _close_caches(tc, jc)


@pytest.mark.parametrize("ssm_backend", ["chunked", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch, ssm_backend):
    jm, jp, tm, tp = _models(arch, ssm_backend)
    toks = _tokens(tm.cfg.vocab_size, (B, 33), 4)
    labels = _tokens(tm.cfg.vocab_size, (B, 33), 5)
    jl, jaux = jm.loss(jp, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labels)})
    tl, taux = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                            "labels": torch.from_numpy(labels)})
    _close(tl.detach(), jl, TOL)
    _close(taux["nll"].detach(), jaux["nll"], TOL)


def _aten_ops(fn) -> int:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("aten::"))


@pytest.mark.parametrize("mode", ["rwkv6", "ssd"])
@pytest.mark.parametrize("factored", [False, True])
def test_chunked_form_adds_few_ops_per_chunk(mode, factored):
    """The chunked form computes every chunk's terms at once and loops only
    over the state entering each chunk: doubling the chunks adds a handful
    of operations per chunk, where a loop over the whole chunk body added
    dozens and made full-width training host-bound on the card (hundreds
    of thousands of launches a hymba-1.5b step)."""
    counts = []
    for n in (8, 16):
        q, k, v, ld, u, _ = (_t(a) for a in _la_inputs(mode, T=4 * n))
        counts.append(_aten_ops(lambda: ssm.chunked_linear_attention(
            q, k, v, ld, u, chunk=4, factored=factored, sub=2)))
    assert (counts[1] - counts[0]) / 8 <= 8, counts


def test_training_runtime_pins_the_chunked_ssm_backend():
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.runtime.steps import make_runtime
    rcfg = RunConfig(model=reduced(get_arch("rwkv6-3b")),
                     shape=ShapeConfig("t", "train", 16, 2),
                     attention_backend="kernel", ssm_factored=True)
    rt = make_runtime(rcfg)
    assert rt.ssm_backend == "chunked" and rt.ssm_factored


def test_port_params_have_the_jax_layout():
    for arch in ARCHS:
        jm, jp, tm, _ = _models(arch, "kernel")
        own = tm.init_params(torch.Generator().manual_seed(0))
        flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
        assert len(flat_j) == len(jax.tree_util.tree_leaves(
            jax.tree.map(np.asarray, own)))
        for path, leaf in flat_j:
            node = own
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape, path
            assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path


# ----------------------------------------------------------------- serving
REDUCE = dict(layers=2, d_model=64, vocab=128, d_ff=128)
LONG, SHORT, BUDGET, SLOTS = 70, 37, 24, 4


def _workload(synth, cfg):
    """4 prompts of 70 tokens (past the reduced window of 64: the prefill
    ring wraps) with budgets up to 24, then 4 of 37 tokens with budget 5;
    lockstep batches of 4 share a prompt length."""
    reqs = synth(cfg, SLOTS, LONG, max_new_tokens=(2, BUDGET))
    short = synth(cfg, SLOTS, SHORT, max_new_tokens=5, seed=1)
    for r in short:
        r.rid += 100
    return reqs + short


@pytest.fixture(scope="module", params=ARCHS)
def jax_run(request):
    """The JAX continuous engine's tokens on the workload, and its
    parameters."""
    arch = request.param
    eng, jcfg = jax_build_engine(
        arch, batch=SLOTS, prompt_len=LONG, max_new_tokens=BUDGET,
        reduce_kw=REDUCE, clock=JaxSimClock(), scheduler="continuous")
    rep = eng.run(_workload(jax_synth_requests, jcfg))
    return arch, _tokens_of(rep), jax.tree.map(np.asarray, eng.params)


def _tokens_of(report):
    return {m.rid: [int(t) for t in m.tokens] for m in report.metrics}


@pytest.mark.parametrize("scheduler", ["continuous", "static"])
def test_engine_matches_jax_engine(jax_run, scheduler):
    arch, want, params = jax_run
    eng, cfg = build_engine(arch, batch=SLOTS, prompt_len=LONG,
                            max_new_tokens=BUDGET, scheduler=scheduler,
                            reduce_kw=REDUCE, clock=SimClock(),
                            params=params, device="cpu")
    got = _tokens_of(eng.run(_workload(synth_requests, cfg)))
    assert got == want


def test_paged_engine_refuses_ssm_and_hybrid(jax_run):
    arch, _, params = jax_run
    eng, cfg = build_engine(arch, batch=SLOTS, prompt_len=LONG,
                            max_new_tokens=BUDGET, scheduler="paged",
                            reduce_kw=REDUCE, params=params, device="cpu")
    with pytest.raises(ValueError, match="full-attention decoder-only"):
        eng.run(_workload(synth_requests, cfg))
