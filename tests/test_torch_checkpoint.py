"""The port's checkpoints, resume and prefetching iterator on the CPU, the
counterparts of ``tests/test_runtime.py``'s checkpoint, train-loop and
``SyntheticLM.iterate`` tests, against the JAX package where both run:

* ``checkpoint.py``: round trip of nested dicts, bf16 leaves (saved as
  their uint16 bits), an ``AdamWState`` with ``Q8`` moments and its
  ``step``, restored IN PLACE into the target's tensors; the reference's
  leaf files and numbering for the same tree; an uncommitted step stays
  invisible, a corrupt newest step is skipped with the target untouched;
  an async save is not reached by an in-place update made right after it
  returns;
* ``train_loop.run`` with ``ckpt_dir``: a resumed run's losses equal an
  unbroken run's bit for bit (f32 and bf16 params), and its
  ``resumed_from``, ``final_step`` and ``checkpoints`` equal the reference
  loop's, its losses within 1e-5 of the reference's (the frameworks round
  the same f32 arithmetic in other orders); no checkpoint after a failed
  update;
* ``SyntheticLM.iterate``: the first batch, data-parallel shards, each
  step built once and the producer joined on close.
"""
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import checkpoint as jax_ckpt
from repro.configs import MeshConfig, RunConfig, ShapeConfig
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.runtime import train_loop as jax_train_loop
from repro.runtime.steps import build_train_step as jax_build_train_step
from repro_torch._tree import tree_leaves
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import RunConfig as TorchRunConfig
from repro_torch.configs import ShapeConfig as TorchShapeConfig
from repro_torch.configs import get_arch, reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.train import build_trainer
from repro_torch.optim.adamw import Q8, AdamW, AdamWState
from repro_torch.runtime import train_loop
from repro_torch.runtime.steps import build_train_step

torch.set_num_threads(2)
ARCH = "granite-3-8b"


def _state_tree(seed=0, state_dtype="int8"):
    """{"params", "opt"}: f32 and bf16 params, an int leaf, and an AdamW
    state after one update (int8 moments: Q8 leaves, and an f32 leaf that
    does not split into blocks)."""
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn((4, 32), generator=g),
              "emb": torch.randn((8, 16), generator=g).to(torch.bfloat16),
              "b": {"scale": torch.randn((5,), generator=g)}}
    opt = AdamW(lr_fn=lambda s: 1e-2, state_dtype=state_dtype)
    state = opt.init(params)
    grads = {"w": torch.randn((4, 32), generator=g),
             "emb": torch.randn((8, 16), generator=g),
             "b": {"scale": torch.randn((5,), generator=g)}}
    opt.update(grads, state, params)
    return {"params": params, "opt": state,
            "ids": torch.arange(6, dtype=torch.int32)}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(step=0, master=_zeros_like(tree.master),
                          m=_zeros_like(tree.m), v=_zeros_like(tree.v))
    if isinstance(tree, Q8):
        return Q8(q=torch.zeros_like(tree.q),
                  scale=torch.zeros_like(tree.scale))
    return torch.zeros_like(tree)


def _tensors(tree):
    return [x for x in ckpt._leaves(tree) if torch.is_tensor(x)]


def _assert_equal(got, want):
    assert ckpt._structure(got) == ckpt._structure(want)
    for a, b in zip(ckpt._leaves(got), ckpt._leaves(want)):
        if torch.is_tensor(b):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)
        else:
            assert a == b


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_checkpoint_roundtrip(tmp_ckpt_dir, state_dtype):
    tree = _state_tree(state_dtype=state_dtype)
    assert tree["opt"].step == 1
    if state_dtype == "int8":
        assert isinstance(tree["opt"].m["w"], Q8)
    ckpt.save(tmp_ckpt_dir, 7, tree)
    assert ckpt.available_steps(tmp_ckpt_dir) == [7]
    target = _zeros_like(tree)
    held = _tensors(target)
    step, restored = ckpt.restore_latest(tmp_ckpt_dir, target)
    assert step == 7 and restored is target
    _assert_equal(restored, tree)
    assert restored["opt"].step == 1
    # restored in place: the target's own tensors hold the values
    assert all(a is b for a, b in zip(_tensors(restored), held))


def test_checkpoint_layout_and_bf16_bits(tmp_ckpt_dir):
    tree = _state_tree()
    ckpt.save(tmp_ckpt_dir, 3, tree)
    base = Path(tmp_ckpt_dir) / "step_3"
    names = {p.name for p in base.iterdir()}
    n = len(ckpt._leaves(tree))
    assert names == {"meta.json", "_COMMITTED"} | {
        f"leaf_{i}.npy" for i in range(n)}
    assert not any(p.name.startswith(".tmp") for p in
                   Path(tmp_ckpt_dir).iterdir())
    meta = json.loads((base / "meta.json").read_text())
    assert meta["step"] == 3 and meta["n_leaves"] == n
    dtypes = [e["dtype"] for e in meta["manifest"]]
    i = dtypes.index("bfloat16")
    raw = np.load(base / f"leaf_{i}.npy")
    assert raw.dtype == np.uint16
    emb = tree["params"]["emb"]
    assert np.array_equal(raw, emb.view(torch.int16).numpy().view(np.uint16))
    # the AdamWState's step, after "ids" in key order, is a 0-d int64 leaf
    assert [e for e in meta["manifest"] if e["shape"] == []] == [
        {"i": 1, "shape": [], "dtype": "int64"}]


def test_checkpoint_leaves_match_the_reference(tmp_path):
    """The same tree saved by both packages: the same leaf files (dict keys
    in sorted order), each with the same values, shape and dtype."""
    rng = np.random.default_rng(0)
    tree = {"b": {"z": rng.standard_normal((3, 4)).astype(np.float32),
                  "a": np.arange(5, dtype=np.int32)},
            "a": rng.standard_normal((6,)).astype(np.float32)}
    jax_ckpt.save(tmp_path / "jax", 2, jax.tree.map(jnp.asarray, tree))
    ckpt.save(tmp_path / "torch", 2, params_from_jax(tree, "cpu"))
    j, t = tmp_path / "jax" / "step_2", tmp_path / "torch" / "step_2"
    leaves = sorted(p.name for p in j.glob("leaf_*.npy"))
    assert leaves == sorted(p.name for p in t.glob("leaf_*.npy"))
    for name in leaves:
        a, b = np.load(j / name), np.load(t / name)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_checkpoint_uncommitted_invisible(tmp_ckpt_dir):
    tree = {"a": torch.zeros(3)}
    ckpt.save(tmp_ckpt_dir, 1, tree)
    # a crash mid-save: step_2 exists without its _COMMITTED marker
    (Path(tmp_ckpt_dir) / "step_2").mkdir()
    assert ckpt.available_steps(tmp_ckpt_dir) == [1]
    step, _ = ckpt.restore_latest(tmp_ckpt_dir, tree)
    assert step == 1


@pytest.mark.parametrize("damage", ["truncated_leaf", "missing_leaf",
                                    "no_meta"])
def test_corrupt_newest_step_is_skipped(tmp_ckpt_dir, damage):
    old, new = _state_tree(seed=1), _state_tree(seed=2)
    ckpt.save(tmp_ckpt_dir, 1, old)
    ckpt.save(tmp_ckpt_dir, 2, new)
    base = Path(tmp_ckpt_dir) / "step_2"
    n = len(ckpt._leaves(new))
    last = base / f"leaf_{n - 1}.npy"
    if damage == "truncated_leaf":
        last.write_bytes(last.read_bytes()[:-8])
    elif damage == "missing_leaf":
        last.unlink()
    else:
        (base / "meta.json").unlink()
    assert ckpt.available_steps(tmp_ckpt_dir) == [1, 2]
    target = _zeros_like(old)
    step, restored = ckpt.restore_latest(tmp_ckpt_dir, target)
    assert step == 1
    _assert_equal(restored, old)


def test_restore_refuses_another_tree_and_leaves_it_untouched(tmp_ckpt_dir):
    ckpt.save(tmp_ckpt_dir, 1, {"a": torch.ones(4), "b": torch.ones(2)})
    for target in ({"a": torch.zeros(4), "b": torch.zeros(3)},
                   {"a": torch.zeros(4)}):
        with pytest.raises(ValueError):
            ckpt.restore(tmp_ckpt_dir, 1, target)
        assert all(float(t.abs().sum()) == 0 for t in tree_leaves(target))
        assert ckpt.restore_latest(tmp_ckpt_dir, target) == (None, target)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_ckpt_dir, 5, {"a": torch.zeros(4)})


@pytest.mark.parametrize("saved,target", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_restore_refuses_another_dtype_and_leaves_it_untouched(
        tmp_ckpt_dir, saved, target):
    """An f32 run's checkpoint does not resume a bf16 run (or the other
    way): the trees match in structure and shapes, not in dtype."""
    ckpt.save(tmp_ckpt_dir, 1, {"a": torch.ones(4), "w": torch.ones(
        (2, 3), dtype=saved)})
    tree = {"a": torch.zeros(4), "w": torch.zeros((2, 3), dtype=target)}
    with pytest.raises(ValueError, match="saved as"):
        ckpt.restore(tmp_ckpt_dir, 1, tree)
    assert all(float(t.float().abs().sum()) == 0 for t in tree_leaves(tree))
    assert ckpt.restore_latest(tmp_ckpt_dir, tree) == (None, tree)


def test_async_save_is_not_reached_by_a_later_update(tmp_ckpt_dir):
    """Every host copy is taken before ``save(..., blocking=False)``
    returns: an update in place right after it does not reach the
    files."""
    tree = _state_tree(state_dtype="float32")
    want = _zeros_like(tree)
    for a, b in zip(_tensors(want), _tensors(tree)):
        a.copy_(b)
    want["opt"].step = tree["opt"].step
    t = ckpt.save(tmp_ckpt_dir, 3, tree, blocking=False)
    assert isinstance(t, threading.Thread)
    for x in _tensors(tree):
        x.add_(1)
    tree["opt"].step += 5
    t.join()
    assert ckpt.available_steps(tmp_ckpt_dir) == [3]
    got = ckpt.restore(tmp_ckpt_dir, 3, _zeros_like(tree))
    _assert_equal(got, want)


# ------------------------------------------------------------ train loop
def _trainer(**kw):
    return build_trainer(ARCH, steps=12, batch=2, seq=32,
                         reduce_kw=dict(layers=2, d_model=64), device="cpu",
                         **kw)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_resumed_losses_equal_an_unbroken_run(tmp_ckpt_dir, param_dtype):
    step, p, o, data, rcfg = _trainer(param_dtype=param_dtype)
    assert rcfg.param_dtype == param_dtype
    assert p["layers"]["attn"]["wq"].dtype == getattr(torch, param_dtype)
    unbroken = train_loop.run(step, p, o, data.batch_at, total_steps=12)
    step, p, o, data, _ = _trainer(param_dtype=param_dtype)
    first = train_loop.run(step, p, o, data.batch_at, total_steps=8,
                           ckpt_dir=tmp_ckpt_dir, ckpt_every=4)
    assert first.checkpoints == [3, 7] and first.resumed_from is None
    # a fresh state from another seed: the loop restores the checkpoint
    step, p, o, data, _ = _trainer(param_dtype=param_dtype)
    for t in tree_leaves(p):
        t.normal_(generator=torch.Generator().manual_seed(9))
    resumed = train_loop.run(step, p, o, data.batch_at, total_steps=12,
                             ckpt_dir=tmp_ckpt_dir, ckpt_every=4)
    assert resumed.resumed_from == 7 and resumed.final_step == 12
    assert resumed.checkpoints == [11] and o.step == 12
    assert resumed.losses == unbroken.losses[8:]
    assert [m["grad_norm"] for m in resumed.metrics] == \
        [m["grad_norm"] for m in unbroken.metrics[8:]]
    # a run that is already done resumes and takes no step
    done = train_loop.run(step, p, o, data.batch_at, total_steps=12,
                          ckpt_dir=tmp_ckpt_dir)
    assert done.resumed_from == 11 and done.final_step == 12
    assert done.losses == [] and done.checkpoints == []


def test_resume_matches_the_reference_loop(tmp_path):
    """The reference's tests/test_runtime.py::test_train_loop_resume run
    through both loops from the same params and batches: the same
    resume points, steps and checkpoints, losses within 1e-5."""
    jcfg = jax_reduced(jax_get_arch(ARCH), layers=2, d_model=64, vocab=256,
                       d_ff=128)
    tcfg = reduced(get_arch(ARCH), layers=2, d_model=64, vocab=256,
                   d_ff=128)
    jrcfg = RunConfig(model=jcfg, shape=ShapeConfig("t", "train", 32, 2),
                      mesh=MeshConfig(shape=(1, 1), axes=("data", "model")),
                      param_dtype="float32", attention_backend="dense",
                      learning_rate=1e-3, warmup_steps=2)
    trcfg = TorchRunConfig(model=tcfg,
                           shape=TorchShapeConfig("t", "train", 32, 2),
                           param_dtype="float32", attention_backend="kernel",
                           learning_rate=1e-3, warmup_steps=2)
    p0 = None

    def jax_pieces():
        nonlocal p0
        step, model, opt = jax_build_train_step(jrcfg, total_steps=12)
        params = model.init_params(jax.random.PRNGKey(0))
        p0 = jax.tree.map(np.array, params)
        return (jax.jit(step, donate_argnums=(0, 1)), params,
                opt.init(params), JaxSyntheticLM(jcfg, 2, 32).batch_at)

    def torch_pieces():
        step, _, opt = build_train_step(trcfg, total_steps=12, device="cpu")
        params = params_from_jax(p0, "cpu")
        return (step, params, opt.init(params),
                SyntheticLM(tcfg, 2, 32, device="cpu").batch_at)

    runs = {}
    for name, pieces, loop in (("jax", jax_pieces, jax_train_loop),
                               ("torch", torch_pieces, train_loop)):
        d = tmp_path / name
        r1 = loop.run(*pieces(), total_steps=8, ckpt_dir=str(d),
                      ckpt_every=4)
        r2 = loop.run(*pieces(), total_steps=12, ckpt_dir=str(d),
                      ckpt_every=4)
        runs[name] = (r1, r2)
    for (j, t) in zip(runs["jax"], runs["torch"]):
        assert (t.resumed_from, t.final_step, t.checkpoints) == \
            (j.resumed_from, j.final_step, j.checkpoints)
        np.testing.assert_allclose(t.losses, j.losses, rtol=1e-5, atol=0)
    assert runs["torch"][1].resumed_from == runs["torch"][0].checkpoints[-1]


def test_no_checkpoint_after_a_failed_update(tmp_ckpt_dir):
    step, p, o, data, _ = _trainer()

    def failing(params, state, batch):
        if state.step == 2:
            raise train_loop.UpdateFailed("update failed half way")
        return step(params, state, batch)

    with pytest.raises(train_loop.UpdateFailed):
        train_loop.run(failing, p, o, data.batch_at, total_steps=6,
                       ckpt_dir=tmp_ckpt_dir, ckpt_every=1)
    assert ckpt.available_steps(tmp_ckpt_dir) == [0, 1]


# ------------------------------------------------------------ iterate
def test_data_prefetch_iterator():
    cfg = reduced(get_arch(ARCH))
    d = SyntheticLM(cfg, batch=2, seq=32, device="cpu")
    it = d.iterate(start_step=0)
    b0 = next(it)
    assert torch.equal(b0["tokens"], d.batch_at(0)["tokens"])
    it.close()


def test_iterate_matches_the_reference():
    jd = JaxSyntheticLM(jax_reduced(jax_get_arch(ARCH)), 4, 32, seed=3)
    td = SyntheticLM(reduced(get_arch(ARCH)), 4, 32, seed=3, device="cpu")
    jit, tit = jd.iterate(start_step=5), td.iterate(start_step=5)
    try:
        for _ in range(3):
            j, t = next(jit), next(tit)
            for name in ("tokens", "labels"):
                np.testing.assert_array_equal(t[name].numpy(),
                                              np.asarray(j[name]))
    finally:
        jit.close()
        tit.close()


def test_iterate_respects_dp_sharding():
    cfg = reduced(get_arch(ARCH))
    d = SyntheticLM(cfg, batch=8, seq=32, seed=2, device="cpu")
    it = d.iterate(start_step=3, shard=1, num_shards=4)
    try:
        got = next(it)
    finally:
        it.close()
    want = d.batch_at(3, shard=1, num_shards=4)
    assert got["tokens"].shape[0] == 2              # 8 rows / 4 shards
    assert torch.equal(got["tokens"], want["tokens"])


def test_iterate_builds_each_step_once_and_joins():
    cfg = reduced(get_arch(ARCH))
    calls = []

    class Counting(SyntheticLM):
        def batch_at(self, step, shard=0, num_shards=1):
            calls.append(step)
            return super().batch_at(step, shard=shard,
                                    num_shards=num_shards)

    d = Counting(cfg, batch=2, seq=16, device="cpu")
    before = set(threading.enumerate())
    it = d.iterate(start_step=0, prefetch=1)
    next(it)
    spawned = [t for t in threading.enumerate() if t not in before]
    assert spawned, "no producer thread spawned"
    time.sleep(1.2)        # the queue stays full: the producer blocks
    assert len(calls) == len(set(calls)), sorted(calls)
    it.close()
    for t in spawned:
        assert not t.is_alive(), "producer thread not joined on close"
