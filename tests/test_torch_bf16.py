"""The port in bf16 against the JAX package in bf16, on the CPU: reduced
granite-3-8b and reduced qwen2.5-32b (qkv bias) for the loss, every
gradient leaf and one training step (AdamW with an f32 master, f32
moments and f32 gradient sums, ``build_train_step``), and reduced
llama4-maverick (MoE top-1) for its prefill logits and its engine's greedy
tokens. Parameters are the JAX package's bf16 init, carried across by
:func:`repro_torch.bridge.params_from_jax` (the norm scales and the
router stay f32 in both, as the reference's init leaves them).

Gates. Two bf16 implementations of the same function each carry bf16
rounding: JAX's own bf16 error is measured against JAX in f32 from the
same (bf16) params. The port's bf16 result may differ from JAX's bf16
result by at most ``SQRT2`` times that error (two roundings of the same
size, independent, differ by sqrt(2) times either; measured at the
reduced widths: 0.91-1.13 times), leaf by leaf and over the whole
gradient, and over the whole gradient by at most 2e-2 norm-relative
(the bf16 ``_tol`` of ``tests/test_kernels.py``). A lone leaf is not held
to 2e-2: qwen2.5's key bias, whose gradient is small beside the rest,
carries 2.04e-2 of JAX's own bf16 error. The loss is held within
bf16's relative unit, 2^-8, of JAX's bf16 loss (measured: 3.4e-5). The
engines' tokens are held under ``chip_smoke.py``'s flip rule
(``_flip_check``): identical up to the first differing step, where the
port's top-1/top-2 logit margin must not exceed the largest logit
difference between the two packages at prefill.
"""
import functools
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import MeshConfig, RunConfig, ShapeConfig
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.data.pipeline import synth_requests as jax_synth_requests
from repro.models import Runtime as JaxRuntime
from repro.models import build as jax_build
from repro.runtime.steps import build_train_step as jax_build_train_step
from repro.serving import SimClock as JaxSimClock
from repro.serving import make_engine as jax_make_engine
from repro_torch._tree import tree_leaves
from repro_torch.bridge import params_from_jax
from repro_torch.configs import RunConfig as TorchRunConfig
from repro_torch.configs import ShapeConfig as TorchShapeConfig
from repro_torch.configs import get_arch, reduced
from repro_torch.data.pipeline import SyntheticLM, synth_requests
from repro_torch.launch.serve import build_engine
from repro_torch.models import Runtime, build
from repro_torch.runtime.steps import build_train_step
from repro_torch.serving import SimClock

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
SQRT2 = math.sqrt(2.0)
BF16_TOL = 2e-2
LOSS_TOL = 2.0 ** -8
ARCHS = ["granite-3-8b", "qwen2.5-32b"]
LLAMA4 = "llama4-maverick-400b-a17b"
B, S = 2, 48


@functools.lru_cache(maxsize=1)
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(leaves) -> np.ndarray:
    return np.concatenate([_np(x).ravel() for x in leaves])


def _bf16_gate(port, jax16, jax32, what):
    """The module's gate over lists of leaves: each leaf and the whole."""
    rows = [(i, _rel(p, j), _rel(j, w)) for i, (p, j, w) in
            enumerate(zip(port, jax16, jax32))]
    bad = [r for r in rows if r[1] > SQRT2 * r[2]]
    assert not bad, f"{what}: leaves past sqrt(2) x JAX's own error: {bad}"
    whole = _rel(_flat(port), _flat(jax16))
    own = _rel(_flat(jax16), _flat(jax32))
    assert whole <= SQRT2 * own and whole <= BF16_TOL, (what, whole, own)


def _cfgs(arch, **kw):
    return (jax_reduced(jax_get_arch(arch), **kw),
            reduced(get_arch(arch), **kw))


def _jax_params(jcfg, dtype):
    jm = jax_build(jcfg, JaxRuntime(attention_backend="dense"),
                   param_dtype=dtype)
    return jm, jm.init_params(jax.random.PRNGKey(0))


def _batch(jcfg):
    return JaxSyntheticLM(jcfg, B, S, mean_doc_len=16).batch_at(0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_loss_and_grads_match_jax_in_bf16(arch, backend):
    jcfg, tcfg = _cfgs(arch)
    jm16, jp16 = _jax_params(jcfg, jnp.bfloat16)
    jm32 = jax_build(jcfg, JaxRuntime(attention_backend="dense"),
                     param_dtype=jnp.float32)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
    batch = _batch(jcfg)
    (l16, _), g16 = jax.value_and_grad(jm16.loss, has_aux=True)(jp16, batch)
    (l32, _), g32 = jax.value_and_grad(jm32.loss, has_aux=True)(jp32, batch)

    tm = build(tcfg, Runtime(attention_backend=backend),
               param_dtype=torch.bfloat16, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp16), "cpu")
    leaves = jax.tree.leaves(tp)
    dtypes = {t.dtype for t in leaves}
    assert dtypes == {torch.bfloat16, torch.float32}
    for t in leaves:
        t.requires_grad_()
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, _ = tm.loss(tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    assert [g.dtype for g in grads] == [t.dtype for t in leaves]
    loss = float(loss.detach())
    assert abs(loss - float(l16)) <= LOSS_TOL * abs(float(l16))
    assert abs(float(l32) - float(l16)) <= LOSS_TOL * abs(float(l16))
    _bf16_gate(grads, jax.tree.leaves(g16), jax.tree.leaves(g32),
               f"{arch} {backend} gradients")


def _jax_step(jcfg, dtype, params):
    rcfg = RunConfig(model=jcfg, shape=ShapeConfig("t", "train", S, B),
                     mesh=MeshConfig(shape=(1, 1), axes=("data", "model")),
                     param_dtype=dtype, attention_backend="dense",
                     learning_rate=1e-3, warmup_steps=2)
    step, _, opt = jax_build_train_step(rcfg)
    opt_state = opt.init(params)
    return jax.jit(step)(params, opt_state, _batch(jcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_step_matches_jax_in_bf16(arch):
    """One training step from the same bf16 params and batch: loss,
    grad_norm and the moments (m, and sqrt(v), which carries g's relative
    error) under the module's gate; the f32 master and the bf16 params
    after the update within 2e-2 of JAX's; the port's bf16 params are its
    master rounded once."""
    jcfg, tcfg = _cfgs(arch)
    _, jp16 = _jax_params(jcfg, jnp.bfloat16)
    p0 = jax.tree.map(np.asarray, jp16)
    jp1, jo1, jm = _jax_step(jcfg, "bfloat16", jp16)
    _, jo32, _ = _jax_step(
        jcfg, "float32", jax.tree.map(lambda a: a.astype(jnp.float32), jp16))

    rcfg = TorchRunConfig(model=tcfg,
                          shape=TorchShapeConfig("t", "train", S, B),
                          param_dtype="bfloat16", attention_backend="kernel",
                          learning_rate=1e-3, warmup_steps=2)
    step, _, opt = build_train_step(rcfg, device="cpu")
    tp = params_from_jax(p0, "cpu")
    to = opt.init(tp)
    tb = SyntheticLM(tcfg, B, S, mean_doc_len=16, device="cpu").batch_at(0)
    tp, to, tm = step(tp, to, tb)
    assert to.step == 1 and int(jo1.step) == 1

    loss, want = float(tm["loss"]), float(jm["loss"])
    assert abs(loss - want) <= LOSS_TOL * abs(want)
    gn, gn16 = float(tm["grad_norm"]), float(jm["grad_norm"])
    assert abs(gn - gn16) <= LOSS_TOL * gn16
    _bf16_gate(tree_leaves(to.m), jax.tree.leaves(jo1.m),
               jax.tree.leaves(jo32.m), f"{arch} m")
    _bf16_gate([torch.sqrt(v) for v in tree_leaves(to.v)],
               [jnp.sqrt(v) for v in jax.tree.leaves(jo1.v)],
               [jnp.sqrt(v) for v in jax.tree.leaves(jo32.v)],
               f"{arch} sqrt(v)")
    for got, want in ((tree_leaves(to.master), jax.tree.leaves(jo1.master)),
                      (tree_leaves(tp), jax.tree.leaves(jp1))):
        assert _rel(_flat(got), _flat(want)) <= BF16_TOL
        assert [g.dtype for g in got] == [
            torch.bfloat16 if w.dtype == jnp.bfloat16 else torch.float32
            for w in want]
    for p, ma in zip(tree_leaves(tp), tree_leaves(to.master)):
        assert torch.equal(p, ma.to(p.dtype))


def _llama4_cfgs():
    return _cfgs(LLAMA4, layers=2, d_model=64, vocab=128, d_ff=128)


def test_llama4_prefill_logits_match_jax_in_bf16():
    jcfg, tcfg = _llama4_cfgs()
    jm16, jp16 = _jax_params(jcfg, jnp.bfloat16)
    jm32 = jax_build(jcfg, JaxRuntime(attention_backend="dense"),
                     param_dtype=jnp.float32)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
    assert jp16["layers"]["moe"]["router"].dtype == jnp.float32
    tokens = np.random.default_rng(3).integers(1, jcfg.vocab_size, (2, 12),
                                               dtype=np.int32)
    l16, _ = jm16.prefill(jp16, {"tokens": jnp.asarray(tokens)}, 16)
    l32, _ = jm32.prefill(jp32, {"tokens": jnp.asarray(tokens)}, 16)
    for backend in ("dense", "kernel"):
        tm = build(tcfg, Runtime(attention_backend=backend),
                   param_dtype=torch.bfloat16, device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp16), "cpu")
        lt, caches = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, 16)
        assert lt.dtype == torch.float32
        assert caches["layers"]["k"].dtype == torch.bfloat16
        _bf16_gate([lt], [l16], [l32], f"llama4 {backend} prefill logits")


PROMPT, BUDGET, SLOTS = 8, 12, 4


def test_llama4_engine_tokens_under_the_flip_rule():
    """The port's bf16 continuous engine against the JAX package's on the
    same bf16 params and requests, under the flip rule."""
    jcfg, tcfg = _llama4_cfgs()
    jm, jp = _jax_params(jcfg, jnp.bfloat16)
    span = PROMPT + BUDGET
    jeng = jax_make_engine("continuous", jm.prefill, jm.decode_step, jp,
                           jm.cache_init, slots=SLOTS, cache_span=span,
                           clock=JaxSimClock())
    jreqs = jax_synth_requests(jcfg, 8, PROMPT, max_new_tokens=(2, BUDGET))
    want = {m.rid: [int(t) for t in m.tokens]
            for m in jeng.run(jreqs).metrics}
    p = jax.tree.map(np.asarray, jp)
    eng, _ = build_engine(LLAMA4, batch=SLOTS, prompt_len=PROMPT,
                          max_new_tokens=BUDGET,
                          reduce_kw=dict(layers=2, d_model=64, vocab=128,
                                         d_ff=128),
                          clock=SimClock(), params=p, param_dtype="bfloat16",
                          device="cpu")
    reqs = synth_requests(tcfg, 8, PROMPT, max_new_tokens=(2, BUDGET))
    got = {m.rid: [int(t) for t in m.tokens] for m in eng.run(reqs).metrics}
    assert sorted(got) == sorted(want)
    # the bound: the largest logit difference of the two at prefill
    tm = build(tcfg, Runtime(attention_backend="dense"),
               param_dtype=torch.bfloat16, device="cpu")
    tp = params_from_jax(p, "cpu")
    bound = 0.0
    for r in reqs:
        lt, _ = tm.prefill(tp, {"tokens": torch.from_numpy(r.prompt[None])},
                           span)
        lj, _ = jm.prefill(jp, {"tokens": jnp.asarray(r.prompt[None])}, span)
        bound = max(bound, float(np.abs(_np(lt) - _np(lj)).max()))

    def margin_at(rid, step):
        req = next(r for r in reqs if r.rid == rid)
        prefix = torch.as_tensor([list(req.prompt) + got[rid][:step]],
                                 dtype=torch.int32)
        lg, _ = tm.prefill(tp, {"tokens": prefix}, prefix.shape[1])
        top2 = torch.topk(lg[0, -1], 2).values
        return {"margin": float(top2[0] - top2[1])}

    flips, problems = _smoke()._flip_check(got, want, margin_at, bound)
    assert not problems, (flips, problems)


def test_builders_default_to_f32_and_take_bf16():
    from repro_torch.launch.train import build_trainer
    kw = dict(steps=1, batch=1, seq=8, reduce_kw=dict(layers=1, d_model=64),
              device="cpu")
    _, p, o, _, rcfg = build_trainer("arctic-480b", **kw)
    assert rcfg.param_dtype == "float32"
    assert {t.dtype for t in tree_leaves(p)} == {torch.float32}
    _, p, o, _, rcfg = build_trainer("arctic-480b", param_dtype="bfloat16",
                                     **kw)
    moe = p["layers"]["moe"]
    assert moe["router"].dtype == torch.float32        # as the reference's
    assert moe["w_in"].dtype == torch.bfloat16
    assert p["layers"]["norm1"]["scale"].dtype == torch.float32
    assert {t.dtype for t in tree_leaves(o.master)} == {torch.float32}
    eng, _ = build_engine("granite-3-8b", batch=1, prompt_len=4,
                          max_new_tokens=2, reduce_kw=dict(layers=1),
                          param_dtype="bfloat16", device="cpu")
    assert eng.params["layers"]["attn"]["wq"].dtype == torch.bfloat16
