"""The port's training slice against the JAX package's, on the CPU: the
synthetic batches, ``Model.loss`` and its gradients, and the trajectory
of ``build_train_step`` as ``examples/quickstart.py`` runs it (reduced
granite-3-8b, rwkv6-3b, hymba-1.5b, stablelm-12b (LayerNorm, untied) and
qwen1.5-110b (QKV bias, untied), f32, lr 1e-3, 5 warmup steps;
hymba's sequences longer than its reduced window of 64, so the windowed
attention trains through it; the ssm mixes in the plain ``chunked``
form that training pins), from the same parameters
(JAX's init, through :func:`repro_torch.bridge.params_from_jax`) and the
same batches. Then the loop's retry, the launcher, and the refusal to run
without a card (checkpoints and resume: ``test_torch_checkpoint.py``).

Tolerances: loss and gradients 1e-4 (atol and rtol), as
``test_torch_model.py``, since the error accumulates over layers; over 10
steps the loss and grad_norm 1e-5 relative (they agree to about 4e-7: the
frameworks round the same f32 arithmetic in other orders). rwkv6-3b's
trajectory is held by its loss alone (within 4e-7 of JAX's): its
grad_norm after a few AdamW steps moves with the order of f32 rounding,
by up to 3.4e-5 between two runs of the port itself on two threads, so
no f32 implementation can hold it to 1e-5; its step-0 gradients are held
leaf by leaf in ``test_loss_and_grads_match_jax``.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import MeshConfig, RunConfig, ShapeConfig
from repro.configs import get_arch, reduced
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import Runtime as JaxRuntime
from repro.models import build as jax_build
from repro.runtime.steps import build_train_step as jax_build_train_step
from repro_torch.bridge import params_from_jax
from repro_torch.configs import RunConfig as TorchRunConfig
from repro_torch.configs import ShapeConfig as TorchShapeConfig
from repro_torch.configs import get_arch as torch_get_arch
from repro_torch.configs import reduced as torch_reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch.train import build_trainer
from repro_torch.models import Runtime, build
from repro_torch.runtime import train_loop
from repro_torch.runtime.steps import build_train_step

torch.set_num_threads(2)
TOL = 1e-4
ARCH = "granite-3-8b"
ARCHS = [ARCH, "rwkv6-3b", "hymba-1.5b", "stablelm-12b", "qwen1.5-110b"]
BATCH, SEQ, STEPS = 4, 64, 10
# per arch: the loss test's and the trajectory's sequence lengths; hymba's
# pass its reduced window of 64
SEQS = {ARCH: (48, SEQ), "rwkv6-3b": (48, SEQ), "hymba-1.5b": (80, 96),
        "stablelm-12b": (48, SEQ), "qwen1.5-110b": (48, SEQ)}
# the trajectory's quantities held per arch (see the module docstring)
HELD = {ARCH: ("loss", "grad_norm"), "rwkv6-3b": ("loss",),
        "hymba-1.5b": ("loss", "grad_norm"),
        "stablelm-12b": ("loss", "grad_norm"),
        "qwen1.5-110b": ("loss", "grad_norm")}


def _cfgs(layers=2, arch=ARCH):
    return (reduced(get_arch(arch), layers=layers),
            torch_reduced(torch_get_arch(arch), layers=layers))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def test_synthetic_batches_are_identical():
    jcfg, tcfg = _cfgs()
    jd = JaxSyntheticLM(jcfg, 3, 40, seed=2, mean_doc_len=16)
    td = SyntheticLM(tcfg, 3, 40, seed=2, mean_doc_len=16, device="cpu")
    for step in (0, 5):
        jb, tb = jd.batch_at(step), td.batch_at(step)
        for name in ("tokens", "labels"):
            assert tb[name].dtype == torch.int32
            np.testing.assert_array_equal(tb[name].numpy(),
                                          np.asarray(jb[name]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend,remat", [("dense", False),
                                           ("kernel", True)])
def test_loss_and_grads_match_jax(backend, remat, arch):
    jcfg, tcfg = _cfgs(arch=arch)
    jm = jax_build(jcfg, JaxRuntime(attention_backend="dense"),
                   param_dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    batch = JaxSyntheticLM(jcfg, 2, SEQS[arch][0],
                           mean_doc_len=16).batch_at(0)
    (jloss, jaux), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, batch)

    tm = build(tcfg, Runtime(attention_backend=backend, remat=remat,
                             ssm_backend="chunked"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    leaves = jax.tree.leaves(tp)
    for t in leaves:
        t.requires_grad_()
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, aux = tm.loss(tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    _close(float(loss.detach()), float(jloss))
    _close(float(aux["nll"].detach()), float(jaux["nll"]))
    assert float(aux["aux_loss"]) == float(jaux["aux_loss"]) == 0.0
    for got, want in zip(grads, jax.tree.leaves(jg)):
        _close(got, want)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(microbatches: int, arch: str = ARCH):
    """examples/quickstart.py's training loop, on SyntheticLM batches."""
    jcfg, _ = _cfgs(arch=arch)
    seq = SEQS[arch][1]
    rcfg = RunConfig(model=jcfg, shape=ShapeConfig("t", "train", seq, BATCH),
                     mesh=MeshConfig(shape=(1, 1), axes=("data", "model")),
                     param_dtype="float32", attention_backend="dense",
                     learning_rate=1e-3, warmup_steps=5,
                     microbatches=microbatches)
    step, model, opt = jax_build_train_step(rcfg)
    p = model.init_params(jax.random.PRNGKey(0))
    p0 = jax.tree.map(np.array, p)      # a copy: the step donates p
    o = opt.init(p)
    jit_step = jax.jit(step, donate_argnums=(0, 1))
    data = JaxSyntheticLM(jcfg, BATCH, seq, mean_doc_len=32)
    out = []
    for i in range(STEPS):
        p, o, m = jit_step(p, o, data.batch_at(i))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return p0, out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("microbatches,remat,lpb,backend", [
    (1, False, 1, "dense"), (1, True, 1, "kernel"), (2, True, 1, "dense"),
    (2, True, 2, "kernel")])
def test_train_step_trajectory_matches_jax(microbatches, remat, lpb,
                                           backend, arch):
    p0, want = _jax_trajectory(microbatches, arch)
    _, tcfg = _cfgs(arch=arch)
    seq = SEQS[arch][1]
    rcfg = TorchRunConfig(
        model=tcfg, shape=TorchShapeConfig("t", "train", seq, BATCH),
        param_dtype="float32", attention_backend=backend,
        learning_rate=1e-3, warmup_steps=5, microbatches=microbatches,
        remat=remat, layers_per_block=lpb)
    step, model, opt = build_train_step(rcfg, device="cpu")
    assert model.rt.remat == remat and model.rt.layers_per_block == lpb
    p = params_from_jax(p0, "cpu")
    o = opt.init(p)
    data = SyntheticLM(tcfg, BATCH, seq, mean_doc_len=32, device="cpu")
    got = []
    for i in range(STEPS):
        p2, o2, m = step(p, o, data.batch_at(i))
        assert p2 is p and o2 is o                    # updated in place
        got.append((float(m["loss"]), float(m["grad_norm"])))
    for i, name in enumerate(("loss", "grad_norm")):
        if name in HELD[arch]:
            np.testing.assert_allclose([g[i] for g in got],
                                       [w[i] for w in want], rtol=1e-5,
                                       atol=0, err_msg=name)
    assert got[-1][0] < got[0][0]


def _small_trainer(**kw):
    return build_trainer(ARCH, steps=4, batch=2, seq=16,
                         reduce_kw=dict(layers=2, d_model=64), device="cpu",
                         **kw)


def test_loop_retries_a_step_that_failed_before_its_update():
    """A failure before the update leaves params and state untouched: the
    retried run's losses equal an undisturbed run's."""
    step, p, o, data, _ = _small_trainer()
    clean = train_loop.run(step, p, o, data.batch_at, total_steps=3)
    step, p, o, data, _ = _small_trainer()
    failed = set()

    def inject(i):
        if i == 1 and i not in failed:
            failed.add(i)
            raise RuntimeError("simulated node failure")

    res = train_loop.run(step, p, o, data.batch_at, total_steps=3,
                         fail_injector=inject)
    assert res.retries == 1 and clean.retries == 0
    assert res.final_step == 3 and len(res.metrics) == 3
    assert res.losses == clean.losses


def test_loop_does_not_retry_a_failed_update():
    step, p, o, data, _ = _small_trainer()
    calls = []

    def bad_update(params, state, batch):
        calls.append(1)
        raise train_loop.UpdateFailed("update failed half way")

    with pytest.raises(train_loop.UpdateFailed):
        train_loop.run(bad_update, p, o, data.batch_at, total_steps=2)
    assert len(calls) == 1


def test_launcher_trains_two_steps_on_the_cpu():
    step, p, o, data, rcfg = _small_trainer(microbatches=2)
    assert rcfg.param_dtype == "float32" and rcfg.attention_backend == "kernel"
    ops.reset_launches()
    res = train_loop.run(step, p, o, data.batch_at, total_steps=2)
    assert res.final_step == 2 and all(np.isfinite(res.losses))
    assert o.step == 2
    assert not any(ops.LAUNCHES.values())       # the CPU launches no kernel


def test_launcher_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        build_trainer(ARCH, steps=1, batch=1, seq=8)
