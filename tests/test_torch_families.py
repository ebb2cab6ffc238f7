"""The port's moe, audio and vlm families against the JAX package's:
reduced arctic-480b (128 experts top-2 with a dense residual MLP, cut to
4), llama4-maverick-400b-a17b (top-1, the vision stub's early fusion),
whisper-large-v3 (encoder-decoder: a bidirectional encoder, the decoder's
cross attention, LayerNorm, sinusoidal positions) and qwen2-vl-72b
(M-RoPE over the vision stub's (t, h, w) positions), each on the port's
``dense`` and ``kernel`` backends (on the CPU the kernel backend runs the
kernels' plain versions).

Held: the loss with the MoE's ``aux_loss`` and ``expert_load``, every
gradient leaf, prefill logits and caches (whisper's cross K/V too),
decode against the JAX decode and against teacher forcing, chunked
prefill with paged decode (moe, vlm), the training step's trajectory
(also of the dense stablelm-12b and qwen1.5-110b),
greedy tokens through the engines (moe, vlm) and through
``serve_loop.generate`` (whisper), the refusals, and the plain attention
functions' non-causal and Sq != Sk lines. Parameters come from the JAX
init through :func:`repro_torch.bridge.params_from_jax`; inputs are
numpy, seeded. Tolerance 1e-4 (atol and rtol), as
``tests/test_torch_model.py``: the error accumulates over layers.
"""
import dataclasses
import functools

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
from repro.launch.serve import build_engine as jax_build_engine
from repro.models import Runtime as JaxRuntime
from repro.models import build as jax_build
from repro.models.frontends import synth_batch as jax_synth_batch
from repro.runtime.serve_loop import generate as jax_generate
from repro.runtime.steps import build_train_step as jax_build_train_step
from repro.serving import SimClock as JaxSimClock
from repro_torch._tree import tree_leaves
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS as ALL_ARCHS
from repro_torch.configs import RunConfig as TorchRunConfig
from repro_torch.configs import ShapeConfig as TorchShapeConfig
from repro_torch.configs import get_arch, reduced
from repro_torch.core.cost import count_cost
from repro_torch.data.pipeline import SyntheticLM, synth_requests
from repro_torch.kernels import ref, work
from repro_torch.launch.serve import build_engine
from repro_torch.models import Runtime, build
from repro_torch.models.frontends import synth_batch
from repro_torch.runtime.serve_loop import generate
from repro_torch.runtime.steps import accumulate_grads, build_train_step
from repro_torch.serving import SimClock

torch.set_num_threads(2)
TOL = 1e-4
ARCHS = ["arctic-480b", "llama4-maverick-400b-a17b", "whisper-large-v3",
         "qwen2-vl-72b"]
DECODER_ONLY = ["arctic-480b", "llama4-maverick-400b-a17b", "qwen2-vl-72b"]
BACKENDS = ["dense", "kernel"]
B, S, SPAN = 2, 12, 24


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _no_drop(cfg):
    """The config with a capacity no routing can overflow, so that a
    token's FFN output does not depend on the other tokens in its batch
    (decode against teacher forcing, as ``tests/test_archs.py``)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def _models(arch, backend, no_drop=False, seed=0):
    jcfg, cfg = jax_reduced(jax_get_arch(arch)), reduced(get_arch(arch))
    if no_drop:
        jcfg, cfg = _no_drop(jcfg), _no_drop(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)  # the copy
    jm = jax_build(jcfg, JaxRuntime(attention_backend="dense"),
                   param_dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = build(cfg, Runtime(attention_backend=backend), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _to_torch(batch: dict) -> dict:
    return params_from_jax(jax.tree.map(np.asarray, batch), "cpu")


def _prefill_batch(cfg, batch, seq, seed):
    """The JAX prefill batch of ``seq`` positions (the family's input)."""
    return jax_synth_batch(cfg, batch, seq, seed=seed, kind="prefill")


# ------------------------------------------------------------------ build
def test_every_config_builds():
    """All ten architectures build (no parameters drawn)."""
    for name, cfg in ALL_ARCHS.items():
        model = build(cfg, device="cpu")
        assert model.cfg is cfg, name


@pytest.mark.parametrize("arch", ARCHS)
def test_port_params_have_the_jax_layout(arch):
    """The port's own init draws the JAX tree's names, shapes and dtypes
    (moe.{router,w_in,w_gate,w_out,dense}, enc_layers, enc_norm,
    cross_attn, norm_cross, the qkv biases), so the bridge needs no
    transposes."""
    jm, jp, tm, _ = _models(arch, "kernel")
    own = tm.init_params(torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(tree_leaves(own))
    for path, leaf in flat_j:
        node = own
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path


# ------------------------------------------------------------ loss, grads
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, backend):
    """Model.loss on the family's training batch (the vision stub's embeds
    and M-RoPE positions, whisper's audio embeds and tokens): the total,
    nll, aux_loss and expert_load, and the gradient of every leaf."""
    jm, jp, tm, tp = _models(arch, backend)
    batch = jax_synth_batch(jm.cfg, B, 16, seed=1, kind="train")
    (jloss, jaux), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, batch)
    leaves = jax.tree.leaves(tp)
    for t in leaves:
        t.requires_grad_()
    loss, aux = tm.loss(tp, _to_torch(batch))
    # the vision stub's embeds bypass the token table: no gradient there
    # (JAX gives zeros)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    _close(float(loss.detach()), float(jloss))
    assert set(aux) == set(jaux)
    _close(float(aux["nll"].detach()), float(jaux["nll"]))
    _close(float(aux["aux_loss"].detach()), float(jaux["aux_loss"]))
    if tm.cfg.moe is not None:
        assert float(jaux["aux_loss"]) > 0
        np.testing.assert_array_equal(aux["expert_load"].numpy(),
                                      np.asarray(jaux["expert_load"]))
    for got, want in zip(grads, jax.tree.leaves(jg)):
        assert got.shape == want.shape
        _close(got, want)


# --------------------------------------------------------- prefill, decode
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, backend):
    """Prefill of the family's prompt batch (whisper: its audio embeds,
    the cross K/V split into caches["cross"]), every cache entry, then 3
    decode steps at per-row and 1 at a scalar position."""
    jm, jp, tm, tp = _models(arch, backend)
    batch = _prefill_batch(jm.cfg, B, S, seed=2)
    jl, jc = jm.prefill(jp, batch, SPAN)
    tl, tc = tm.prefill(tp, _to_torch(batch), SPAN)
    _close(tl, jl)
    assert sorted(tc) == sorted(jc)
    for part in tc:
        assert sorted(tc[part]) == sorted(jc[part])
        for name in tc[part]:
            _close(tc[part][name], jc[part][name])
    rng = np.random.default_rng(3)
    for i in range(4):
        tok = rng.integers(1, tm.cfg.vocab_size, (B, 1), dtype=np.int32)
        if i < 3:
            pos = np.array([S + i, S + 4 + i], np.int32)
            jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
        else:
            jpos, tpos = jnp.int32(S + 8), S + 8
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jpos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), tpos)
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["layers"][name], jc["layers"][name])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch, backend):
    """Incremental decode after a prefill of S tokens equals the last
    logits of a prefill of S + 1 (``tests/test_archs.py``'s check, with a
    capacity no routing overflows): on token prompts, whisper's beside
    its S + 1 audio frames."""
    _, _, tm, tp = _models(arch, backend, no_drop=True, seed=1)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(1, tm.cfg.vocab_size,
                                           (B, S + 1), dtype=np.int32))
    full = {"tokens": tokens}
    if tm.cfg.is_enc_dec:
        full["audio_embeds"] = synth_batch(tm.cfg, B, S + 1, seed=3,
                                           kind="prefill")["audio_embeds"]
    part = {**full, "tokens": tokens[:, :S]}
    _, caches = tm.prefill(tp, part, S + 8)
    got, _ = tm.decode_step(tp, caches, tokens[:, S:], S)
    want, _ = tm.prefill(tp, full, S + 9)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < 1e-5, rel


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_chunked_prefill_and_paged_decode_match_jax(arch, backend):
    """Two prefill chunks into the page pool, then two paged decode steps
    (M-RoPE's three streams and the MoE in every path)."""
    jm, jp, tm, tp = _models(arch, backend)
    ps, npag, num_pages = 4, 5, 12
    toks = np.random.default_rng(1).integers(1, tm.cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    btab = np.array([[3, 7, 1, 0, 0], [2, 9, 11, 5, 0]], np.int32)
    jc = jm.paged_cache_init(num_pages, ps)
    tc = tm.paged_cache_init(num_pages, ps)
    for lo, hi in ((0, 8), (8, S)):
        n_live = -(-hi // ps)
        jl, jc = jm.prefill_chunk(jp, jc, jnp.asarray(toks[:, lo:hi]),
                                  jnp.asarray(btab[:, :n_live]), lo)
        tl, tc = tm.prefill_chunk(tp, tc, torch.from_numpy(toks[:, lo:hi]),
                                  torch.from_numpy(btab[:, :n_live]), lo)
        _close(tl, jl)
    for i in range(2):
        tok = np.random.default_rng(20 + i).integers(
            1, tm.cfg.vocab_size, (B, 1), dtype=np.int32)
        pos = np.array([S + i, S + i], np.int32)
        jl, jc = jm.decode_step_paged(jp, jc, jnp.asarray(tok),
                                      jnp.asarray(pos), jnp.asarray(btab))
        tl, tc = tm.decode_step_paged(tp, tc, torch.from_numpy(tok),
                                      torch.from_numpy(pos),
                                      torch.from_numpy(btab))
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["layers"][name], jc["layers"][name])


def test_unrotated_key_biases_have_no_gradient():
    """whisper's keys are not rotated, so a key bias adds q . bk to every
    score of a query's row, which the softmax ignores: its gradient is
    zero in exact arithmetic and rounding noise in f32 (the premise of
    ``chip_smoke.py``'s ZERO_GRAD_LEAVES); M-RoPE rotates qwen2-vl's key
    bias by position, so its gradient is not."""
    for arch, zero in (("whisper-large-v3", True), ("qwen2-vl-72b", False)):
        _, _, tm, tp = _models(arch, "kernel")
        batch = synth_batch(tm.cfg, B, 16, seed=1, kind="train")
        grads, _, _ = accumulate_grads(tm, tp, batch, 1)
        total = float(torch.stack([g.norm() for g in
                                   tree_leaves(grads)]).norm())
        bk = [grads["layers"]["attn"]["bk"]]
        if tm.cfg.is_enc_dec:
            bk += [grads["layers"]["cross_attn"]["bk"],
                   grads["enc_layers"]["attn"]["bk"]]
        ratio = max(float(g.norm()) for g in bk) / total
        assert (ratio < 1e-6) == zero, (arch, ratio)


# ---------------------------------------------------------------- training
STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 4, 32
# the trajectory also holds the two dense configurations the other files
# hold only a step of: stablelm-12b (LayerNorm, head dim 160 at full
# width) and qwen1.5-110b (QKV bias)
TRAJECTORY_ARCHS = ARCHS + ["stablelm-12b", "qwen1.5-110b"]


@functools.lru_cache(maxsize=None)
def _jax_trajectory(arch: str, microbatches: int):
    """The JAX training step over SyntheticLM batches (the family's
    frontend batches), f32, lr 1e-3, 2 warmup steps."""
    jcfg = jax_reduced(jax_get_arch(arch))
    rcfg = RunConfig(model=jcfg, shape=ShapeConfig("t", "train", TRAIN_SEQ,
                                                   TRAIN_BATCH),
                     mesh=MeshConfig(shape=(1, 1), axes=("data", "model")),
                     param_dtype="float32", attention_backend="dense",
                     learning_rate=1e-3, warmup_steps=2,
                     microbatches=microbatches)
    step, model, opt = jax_build_train_step(rcfg)
    p = model.init_params(jax.random.PRNGKey(0))
    p0 = jax.tree.map(np.array, p)      # a copy: the step donates p
    o = opt.init(p)
    jit_step = jax.jit(step, donate_argnums=(0, 1))
    data = JaxSyntheticLM(jcfg, TRAIN_BATCH, TRAIN_SEQ, mean_doc_len=16)
    out = []
    for i in range(STEPS):
        p, o, m = jit_step(p, o, data.batch_at(i))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return p0, out


@pytest.mark.parametrize("microbatches,backend", [(1, "dense"),
                                                  (2, "kernel")])
@pytest.mark.parametrize("arch", TRAJECTORY_ARCHS)
def test_train_step_trajectory_matches_jax(arch, microbatches, backend):
    """STEPS steps of build_train_step from the JAX init on the same
    batches: loss (with the MoE's aux_loss, which reaches the gradient)
    and grad_norm within 1e-5 relative; the moe family reports each
    step's aux_loss and expert_load (L, E), summed over microbatches."""
    p0, want = _jax_trajectory(arch, microbatches)
    cfg = reduced(get_arch(arch))
    rcfg = TorchRunConfig(
        model=cfg, shape=TorchShapeConfig("t", "train", TRAIN_SEQ,
                                          TRAIN_BATCH),
        param_dtype="float32", attention_backend=backend, learning_rate=1e-3,
        warmup_steps=2, microbatches=microbatches)
    step, _, opt = build_train_step(rcfg, device="cpu")
    params = params_from_jax(p0, "cpu")
    state = opt.init(params)
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, mean_doc_len=16,
                       device="cpu")
    for i, (loss, gnorm) in enumerate(want):
        params, state, m = step(params, state, data.batch_at(i))
        _close(float(m["loss"]), loss, 1e-5)
        _close(float(m["grad_norm"]), gnorm, 1e-5)
        if cfg.moe is not None:
            load = m["expert_load"]
            assert tuple(load.shape) == (cfg.num_layers,
                                         cfg.moe.num_experts)
            pairs = TRAIN_BATCH * TRAIN_SEQ * cfg.moe.top_k
            assert 0 < float(load.sum()) <= cfg.num_layers * pairs
            assert float(m["aux_loss"]) > 0
        else:
            assert "expert_load" not in m


def test_aux_loss_reaches_the_router_gradient():
    """Without the aux loss the router's gradient changes: the MoE's
    load-balance loss is part of the gradient, not only reported."""
    _, _, tm, tp = _models("arctic-480b", "kernel")
    batch = synth_batch(tm.cfg, B, 16, seed=1, kind="train")
    grads, _, stats = accumulate_grads(tm, tp, batch, 1)
    plain = dataclasses.replace(tm.cfg, moe=dataclasses.replace(
        tm.cfg.moe, router_aux_weight=0.0))
    g0, _, _ = accumulate_grads(build(plain, tm.rt, device="cpu"), tp, batch,
                                1)
    router = grads["layers"]["moe"]["router"]
    assert float(stats["aux_loss"]) > 0
    assert float((router - g0["layers"]["moe"]["router"]).abs().max()) > 1e-6


# ---------------------------------------------------------------- serving
REDUCE = dict(layers=2, d_model=64, vocab=128, d_ff=128)
PROMPT, BUDGET, SLOTS, PS = 8, 12, 4, 8
SPAN_SERVE = PROMPT + BUDGET
ENGINES = {
    "continuous": dict(batch=SLOTS, scheduler="continuous"),
    "paged": dict(batch=2 * SLOTS, scheduler="paged", page_size=PS,
                  num_pages=SLOTS * SPAN_SERVE // PS,
                  prefill_chunk_tokens=PROMPT // 2),
}


def _workload(synth, cfg):
    reqs = synth(cfg, 8, PROMPT, max_new_tokens=(2, BUDGET))
    short = synth(cfg, 4, PROMPT - 3, max_new_tokens=5, seed=1)
    for r in short:
        r.rid += 100
    return reqs + short


def _tokens_of(report):
    return {m.rid: [int(t) for t in m.tokens] for m in report.metrics}


@pytest.fixture(scope="module", params=["arctic-480b", "qwen2-vl-72b"])
def jax_engine_runs(request):
    """The JAX engines' greedy tokens on the workload, and their (shared)
    parameters."""
    arch = request.param
    out, params = {}, None
    for name, kw in ENGINES.items():
        eng, jcfg = jax_build_engine(
            arch, prompt_len=PROMPT, max_new_tokens=BUDGET, reduce_kw=REDUCE,
            clock=JaxSimClock(), **kw)
        out[name] = _tokens_of(eng.run(_workload(jax_synth_requests, jcfg)))
        params = jax.tree.map(np.asarray, eng.params)
    return arch, out, params


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engines_match_jax_engines(jax_engine_runs, engine):
    """Greedy tokens per rid identical to the JAX engine's (the paged one
    with two-chunk prefills), for reduced arctic (MoE in every prefill,
    chunk and decode step) and qwen2-vl (M-RoPE on token prompts)."""
    arch, want, params = jax_engine_runs
    eng, cfg = build_engine(arch, prompt_len=PROMPT, max_new_tokens=BUDGET,
                            reduce_kw=REDUCE, clock=SimClock(),
                            params=params, device="cpu", **ENGINES[engine])
    assert _tokens_of(eng.run(_workload(synth_requests, cfg))) == \
        want[engine]


def test_whisper_generate_matches_jax():
    """whisper serves through serve_loop.generate on an audio batch: 1500
    frames at the reduced width, a 4-token decoder prompt, 16 greedy
    tokens, identical to the reference's generate."""
    jm, jp, tm, tp = _models("whisper-large-v3", "kernel")
    frames = synth_batch(tm.cfg, 2, 1500, seed=4, kind="prefill")
    jframes = jax_synth_batch(jm.cfg, 2, 1500, seed=4, kind="prefill")
    tokens = np.random.default_rng(5).integers(1, tm.cfg.vocab_size, (2, 4),
                                               dtype=np.int32)
    kw = dict(prompt_len=4, max_new_tokens=16)
    want = jax_generate(jm.prefill, jm.decode_step, jp,
                        {"audio_embeds": jframes["audio_embeds"],
                         "tokens": jnp.asarray(tokens)}, **kw)
    got = generate(tm.prefill, tm.decode_step, tp,
                   {"audio_embeds": frames["audio_embeds"],
                    "tokens": torch.from_numpy(tokens)}, **kw)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def test_whisper_refusals_match_the_reference():
    """An encoder-decoder model has no paged path (the same ValueError as
    the reference's ``paged_cache_init``); the engines, which prefill
    token prompts, refuse it as the reference's engines fail on it."""
    jm, _, tm, _ = _models("whisper-large-v3", "kernel")
    with pytest.raises(ValueError) as jerr:
        jm.paged_cache_init(8, 4)
    with pytest.raises(ValueError) as terr:
        tm.paged_cache_init(8, 4)
    assert str(terr.value) == str(jerr.value)
    assert "enc_dec=True" in str(terr.value)
    with pytest.raises(ValueError, match="serve_loop.generate"):
        build_engine("whisper-large-v3", batch=2, prompt_len=4,
                     max_new_tokens=4, reduce_kw=REDUCE, device="cpu")
    eng, jcfg = jax_build_engine("whisper-large-v3", batch=2, prompt_len=4,
                                 max_new_tokens=4, reduce_kw=REDUCE,
                                 clock=JaxSimClock())
    with pytest.raises(KeyError, match="audio_embeds"):
        eng.run(jax_synth_requests(jcfg, 2, 4, max_new_tokens=4))
    with pytest.raises(ValueError, match="audio_embeds"):
        tm.prefill(None, {"tokens": torch.ones((1, 4), dtype=torch.int32)},
                   8)


# ------------------------------------------------------- attention, counts
def _jax_dense(q, k, v, causal):
    from repro.kernels.ref import flash_attention_ref as jax_flash_ref
    return jax_flash_ref(q, k, v, causal=causal)


@pytest.mark.parametrize("sq,sk,hq,hkv", [(96, 96, 4, 4), (5, 150, 4, 4),
                                          (1, 77, 8, 2), (130, 40, 8, 1)])
def test_noncausal_plain_attention_matches_jax(sq, sk, hq, hkv):
    """The plain versions of K1 and B2-B4 with causal=False and Sq != Sk
    (whisper's encoder and cross attention) against the JAX package's
    ``flash_attention_ref`` and ``jax.vjp`` of it: o, the logsumexp rows
    against the scores' logsumexp, and dq, dk, dv from the plain
    versions' own lse and delta."""
    rng = np.random.default_rng(sq * 7 + sk)
    D = 32
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (1, sq, hq, D), (1, sk, hkv, D), (1, sk, hkv, D), (1, sq, hq, D)))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    want_o, vjp = jax.vjp(lambda a, b, c: _jax_dense(a, b, c, False),
                          jq, jk, jv)
    want_dq, want_dk, want_dv = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    _close(ref.flash_attention_ref(tq, tk, tv, causal=False), want_o, 1e-5)
    o, lse = ref.flash_attention_lse_ref(tq, tk, tv, causal=False)
    _close(o, want_o, 1e-5)
    g = hq // hkv
    s = np.einsum("bqhd,bkhd->bhqk", q, np.repeat(k, g, axis=2)) / np.sqrt(D)
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + \
        s.max(-1)
    _close(lse, want_lse, 1e-5)
    delta = ref.attention_delta(o, tdo)
    dq = ref.flash_attention_dq_ref(tq, tk, tv, tdo, lse, delta,
                                    causal=False)
    dk, dv = ref.flash_attention_dkv_ref(tq, tk, tv, tdo, lse, delta,
                                         causal=False)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        _close(got, want, 1e-5)


def test_noncausal_lse_and_backward_plain_match_pallas():
    """At lengths the Pallas kernels tile (Sq 64, Sk 128), non-causal: the
    plain forward-with-lse and backward against the TPU kernels in
    interpret mode."""
    from repro.kernels.flash_attention import (flash_attention_bwd,
                                               flash_attention_fwd)
    rng = np.random.default_rng(11)
    D, hq, hkv = 32, 4, 2
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (1, 64, hq, D), (1, 128, hkv, D), (1, 128, hkv, D), (1, 64, hq, D)))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    oj, lsej = flash_attention_fwd(jq, jk, jv, causal=False, block_q=64,
                                   block_k=64, interpret=True,
                                   return_lse=True)
    want = flash_attention_bwd(jq, jk, jv, oj, lsej, jdo, causal=False,
                               block_q=64, block_k=64, interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = ref.flash_attention_lse_ref(tq, tk, tv, causal=False)
    _close(o, oj, 1e-5)
    _close(lse, lsej, 1e-5)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, torch.from_numpy(
        np.array(oj)), torch.from_numpy(np.array(lsej)), tdo, causal=False)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "arctic-480b"])
def test_counted_step_of_the_new_families(arch):
    """core/cost.py counts a gradient pass of the new families: one
    forward-with-lse, dq and dkv call per attention (whisper: encoder
    self-attention non-causal, decoder self-attention causal, cross
    attention non-causal at Sq != Sk), with the work of
    ``kernels/work.py`` at each call's mask; the MoE's gathers and
    scatters are counted as aten operations; RMSNorm (arctic) once per
    norm."""
    _, _, tm, tp = _models(arch, "kernel")
    cfg = tm.cfg
    tm = build(cfg, Runtime(remat=False), device="cpu")   # one forward
    seq, enc = 16, 24
    batch = synth_batch(cfg, 1, seq, seed=1, kind="train")
    if cfg.is_enc_dec:
        batch["audio_embeds"] = synth_batch(cfg, 1, enc, seed=2)[
            "audio_embeds"]
    (_, loss, _), cost = count_cost(accumulate_grads, tm, tp, batch, 1)
    assert torch.isfinite(loss)
    L, Hq, Hkv, D = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)

    def meta(s, h):
        return torch.empty((1, s, h, D), device="meta")

    calls = [(seq, seq, True)] * L
    if cfg.is_enc_dec:
        calls += [(enc, enc, False)] * cfg.encoder_layers + \
            [(seq, enc, False)] * L
    for name, fn in (("flash_attention_lse",
                      functools.partial(work.flash_forward, lse=True)),
                     ("flash_attention_dq", work.flash_dq),
                     ("flash_attention_dkv", work.flash_dkv)):
        want = [fn(meta(sq, Hq), meta(sk, Hkv), causal=c, window=0)
                for sq, sk, c in calls]
        got = cost.kernels[name]
        assert got["calls"] == len(calls), name
        assert got["flops"] == sum(w.flops for w in want), name
        assert got["bytes"] == sum(w.bytes for w in want), name
    if cfg.moe is not None:
        ops_seen = set(cost.bytes_by_op)
        assert {"aten.index_put", "aten.index_add",
                "aten.bmm"} <= ops_seen, ops_seen
        assert cost.kernels["rmsnorm"]["calls"] == 2 * L + 1
    else:
        assert "rmsnorm" not in cost.kernels      # LayerNorm: plain
