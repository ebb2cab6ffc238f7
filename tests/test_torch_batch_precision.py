"""The port's batch/precision suite (``bench/suites/batch_precision.py``)
against the reference's ``benchmarks/bench_batch_precision.py`` on the
CPU: the same scenarios, tags, paper references and workloads; the timed
call (the loss gradient of one microbatch through ``accumulate_grads``)
equal to ``jax.grad`` of the reference's ``_grad_fn`` on the same params
and batch, in f32 (1e-4, atol and rtol, as ``tests/test_torch_model.py``)
and in bf16 (the gate of ``tests/test_torch_bf16.py``, against the
reference's gradient in f32 from the same bf16 params); and the suite's
records through the harness on the reduced block."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import benchmarks.bench_batch_precision as ref_suite
from repro.bench.scenario import REGISTRY as JAX_REGISTRY
from repro.models.frontends import synth_batch as jax_synth_batch
from repro_torch.bench import BenchRunner, env_fingerprint, select
from repro_torch.bench.scenario import REGISTRY
from repro_torch.bench.suites import batch_precision
from repro_torch.bridge import params_from_jax
from repro_torch.models.frontends import synth_batch
from test_torch_bf16 import _bf16_gate

torch.set_num_threads(2)
NAMES = ("deploy/batch", "deploy/precision")


@pytest.mark.parametrize("name", NAMES + ("deploy/precision_fullscale",))
def test_scenarios_equal_the_reference(name):
    jax_scen, scen = JAX_REGISTRY[name], REGISTRY[name]
    assert (scen.tags, scen.paper_ref, scen.group) == \
        (jax_scen.tags, jax_scen.paper_ref, jax_scen.group)
    assert [(w.label, w.arch, dict(w.knobs)) for w in scen.workloads] == \
        [(w.label, w.arch, dict(w.knobs)) for w in jax_scen.workloads]


def test_reduced_block_is_the_references():
    cfg, _, _ = ref_suite._grad_fn("float32")
    got = batch_precision.config(True)
    for field in ("num_layers", "d_model", "d_ff", "vocab_size",
                  "num_heads", "num_kv_heads", "qkv_bias",
                  "tie_embeddings"):
        assert getattr(got, field) == getattr(cfg, field), field
    card = batch_precision.config(False)
    assert (card.num_layers, card.d_model, card.num_heads,
            card.num_kv_heads, card.d_ff, card.vocab_size, card.qkv_bias,
            card.tie_embeddings) == (4, 5120, 40, 8, 27648, 152064, True,
                                     False)
    assert card.param_count() == 3_507_556_352


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_timed_gradient_equals_the_references(dtype):
    cfg, jp, g = ref_suite._grad_fn(dtype)
    jbatch = jax_synth_batch(cfg, 8, ref_suite.SEQ, kind="train")
    want = g(jp, jbatch)
    _, model = batch_precision.build_model(dtype, "cpu", True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tbatch = synth_batch(model.cfg, 8, batch_precision.SEQ, kind="train")
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(tbatch[k].numpy(),
                                      np.asarray(jbatch[k]))
    got = jax.tree.leaves(batch_precision.grads(model, tp, tbatch))
    want = jax.tree.leaves(want)
    if dtype == "float32":
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                       rtol=1e-4)
        return
    _, jp32, g32 = ref_suite._grad_fn("float32")
    jp16_32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    want32 = jax.tree.leaves(g32(jp16_32, jbatch))
    _bf16_gate(got, want, want32, "deploy bf16 gradient")


def test_suite_records_on_the_reduced_block():
    scens = [s for s in select(only=",".join(NAMES))]
    assert [s.name for s in scens] == list(NAMES)
    # B1 and B2 of deploy/batch, both dtypes of deploy/precision
    reduced = [dataclasses.replace(s, workloads=tuple(
        dataclasses.replace(w, knobs={**w.knobs, "device": "cpu",
                                      "reduced": True})
        for w in s.workloads if w.knobs.get("batch", 1) <= 2))
        for s in scens]
    try:
        out = BenchRunner(env=env_fingerprint("cpu")).run(reduced)
    finally:
        batch_precision._grad_fn.cache_clear()
    assert out.ok, out.failures
    names = [r.name for r in out.records]
    assert names == ["deploy/batch1", "deploy/batch2",
                     "deploy/precision_float32", "deploy/precision_bfloat16"]
    for r in out.records:
        assert r.derived["tok_s"] > 0 and r.knobs["device"] == "cpu"
        assert r.env["backend"] == "cpu" and r.arch == "qwen2.5-32b"
