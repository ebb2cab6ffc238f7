"""The port's serve launcher plumbing and lockstep loop against the JAX
package's: ``apply_slo`` and ``synth_sessions`` give the same workloads
for the same seed; the launcher parses the reference's flags (prefix
cache, sessions, P/D workers, deadlines, priority mix, fault plan) and
refuses a fault plan for the static and continuous schedulers;
``reject_invalid`` turns impossible requests into "rejected" outcomes as
the reference does; ``runtime/serve_loop.generate`` decodes the
reference's ``generate``'s greedy tokens on its weights (bridged)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import RunConfig, ShapeConfig
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import synth_requests as jax_synth_requests
from repro.data.pipeline import synth_sessions as jax_synth_sessions
from repro.launch.mesh import make_mesh, set_mesh
from repro.launch.serve import apply_slo as jax_apply_slo
from repro.launch.serve import build_engine as jax_build_engine
from repro.runtime.elastic import choose_mesh
from repro.runtime.serve_loop import generate as jax_generate
from repro.runtime.steps import build_serve_steps
from repro.serving import Request as JaxRequest
from repro.serving import SimClock as JaxSimClock
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch, reduced
from repro_torch.data.pipeline import synth_requests, synth_sessions
from repro_torch.launch.serve import apply_slo, build_engine, parse_args
from repro_torch.models import Runtime, build
from repro_torch.runtime.serve_loop import _accepts_cache_span, generate
from repro_torch.serving import FaultPlan, Request, SimClock

torch.set_num_threads(2)
REDUCE = dict(layers=2, d_model=64, vocab=128, d_ff=128)


def _cfgs():
    return (reduced(get_arch("granite-3-8b"), **REDUCE),
            jax_reduced(jax_get_arch("granite-3-8b"), **REDUCE))


def _same(ours, ref):
    for a, b in zip(ours, ref, strict=True):
        assert (a.rid, a.max_new_tokens, a.arrival_s, a.deadline_s,
                a.priority) == (b.rid, b.max_new_tokens, b.arrival_s,
                                b.deadline_s, b.priority)
        assert a.prompt.dtype == b.prompt.dtype
        assert a.prompt.tobytes() == b.prompt.tobytes()


@pytest.mark.parametrize("kw", [
    dict(), dict(turns=4, think_s=100.0, stagger_s=40.0, seed=5),
    dict(rate_per_s=2.0, system_len=8, turn_len=4, max_new_tokens=3,
         seed=3)])
def test_synth_sessions_match_jax(kw):
    cfg, jcfg = _cfgs()
    turns = kw.pop("turns", 3)
    _same(synth_sessions(cfg, 3, turns, **kw),
          jax_synth_sessions(jcfg, 3, turns, **kw))


@pytest.mark.parametrize("deadline,mix,seed", [
    (0.0, "", 0), (30.0, "0:3,5:1", 0), (5.0, "0:1,2:1,7:2", 4)])
def test_apply_slo_matches_jax(deadline, mix, seed):
    cfg, jcfg = _cfgs()
    ours = apply_slo(synth_requests(cfg, 16, 8, seed=seed),
                     deadline_s=deadline, priority_mix=mix, seed=seed)
    ref = jax_apply_slo(jax_synth_requests(jcfg, 16, 8, seed=seed),
                        deadline_s=deadline, priority_mix=mix, seed=seed)
    _same(ours, ref)


def test_launcher_parses_the_new_flags(tmp_path):
    plan = FaultPlan.default(2).to_json(tmp_path / "plan.json")
    args, got = parse_args([
        "--arch", "granite-3-8b", "--scheduler", "disaggregated",
        "--prefill-workers", "2", "--decode-workers", "2",
        "--prefix-cache", "--num-sessions", "4", "--turns", "3",
        "--deadline", "30", "--priority-mix", "0:3,5:1",
        "--fault-plan", str(plan), "--full"])
    assert (args.scheduler, args.prefill_workers, args.decode_workers) == (
        "disaggregated", 2, 2)
    assert args.prefix_cache and (args.num_sessions, args.turns) == (4, 3)
    assert (args.deadline, args.priority_mix) == (30.0, "0:3,5:1")
    assert got == FaultPlan.default(2) and args.full
    args, got = parse_args(["--arch", "granite-3-8b", "--scheduler",
                            "paged", "--fault-plan", "default",
                            "--no-prefix-cache"])
    assert got == FaultPlan.default(0) and not args.prefix_cache
    assert parse_args(["--arch", "x"])[1] is None


@pytest.mark.parametrize("scheduler", ["static", "continuous"])
def test_launcher_refuses_a_fault_plan_without_pages(scheduler, capsys):
    with pytest.raises(SystemExit) as e:
        parse_args(["--arch", "granite-3-8b", "--scheduler", scheduler,
                    "--fault-plan", "default"])
    assert e.value.code == 2
    assert "--fault-plan requires" in capsys.readouterr().err


@pytest.mark.parametrize("scheduler", ["continuous", "paged",
                                       "disaggregated"])
def test_reject_invalid_matches_jax(scheduler):
    kw = dict(batch=2, prompt_len=8, max_new_tokens=4, scheduler=scheduler,
              page_size=4, reduce_kw=REDUCE, reject_invalid=True)
    jeng, _ = jax_build_engine("granite-3-8b", clock=JaxSimClock(), **kw)
    eng, _ = build_engine("granite-3-8b", clock=SimClock(), device="cpu",
                          params=jax.tree.map(np.asarray, jeng.params), **kw)

    def reqs(cls):
        return [cls(rid=0, prompt=np.arange(1, 9, dtype=np.int32),
                    max_new_tokens=4),
                cls(rid=1, prompt=np.arange(1, 9, dtype=np.int32),
                    max_new_tokens=40),
                cls(rid=2, prompt=np.arange(1, 5, dtype=np.int32),
                    max_new_tokens=0)]

    got, want = eng.run(reqs(Request)), jeng.run(reqs(JaxRequest))
    view = [lambda r: {m.rid: (m.outcome, [int(t) for t in m.tokens]
                               if m.tokens is not None else None)
                       for m in r.metrics},
            lambda r: r.summary()["n_rejected"]]
    assert [v(got) for v in view] == [v(want) for v in view]
    assert got.summary()["n_rejected"] == 2


def test_accepts_cache_span_by_signature():
    assert _accepts_cache_span(lambda p, b, s: None)
    assert not _accepts_cache_span(lambda p, b: None)
    assert _accepts_cache_span(lambda *a: None)
    assert _accepts_cache_span(lambda p, b, s, extra=1: None)
    assert _accepts_cache_span(max)            # uninspectable builtin


@pytest.fixture(scope="module")
def jax_serve():
    """The reference's raw serve steps and weights on its reduced cell."""
    _, jcfg = _cfgs()
    span, batch = 16, 3
    rcfg = RunConfig(model=jcfg, shape=ShapeConfig("serve", "decode", span,
                                                    batch),
                     mesh=choose_mesh(jax.device_count()),
                     attention_backend="dense", param_dtype="float32",
                     decode_attention="simple")
    with set_mesh(make_mesh(rcfg.mesh)):
        prefill, decode, model = build_serve_steps(rcfg)
        params = model.init_params(jax.random.PRNGKey(0))
    return rcfg, prefill, decode, params


@pytest.mark.parametrize("max_new,legacy,eos", [
    (6, False, False), (1, False, False), (5, True, False), (8, False, True)])
def test_generate_matches_jax(jax_serve, max_new, legacy, eos):
    rcfg, jprefill, jdecode, jparams = jax_serve
    cfg, _ = _cfgs()
    prompts = np.stack([r.prompt for r in synth_requests(cfg, 3, 6, seed=2)])
    span = 16
    kw = dict(prompt_len=6, max_new_tokens=max_new, cache_span=span)
    with set_mesh(make_mesh(rcfg.mesh)):
        want = jax_generate(jprefill, jdecode, jparams,
                            {"tokens": jnp.asarray(prompts)}, **kw)
    eos_id = int(want.tokens[0, 2]) if eos else None
    if eos:
        with set_mesh(make_mesh(rcfg.mesh)):
            want = jax_generate(jprefill, jdecode, jparams,
                                {"tokens": jnp.asarray(prompts)},
                                eos_id=eos_id, **kw)
    model = build(cfg, Runtime(attention_backend="kernel"),
                  param_dtype=torch.float32, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    prefill = (lambda p, b: model.prefill(p, b, span)) if legacy \
        else model.prefill
    got = generate(prefill, model.decode_step, params,
                   {"tokens": torch.as_tensor(prompts)}, eos_id=eos_id, **kw)
    assert got.tokens.shape == (3, max_new)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.new_tokens, want.new_tokens)
    assert got.total_new_tokens == want.total_new_tokens
    assert (got.decode_s == 0.0) == (max_new == 1)
    if eos:
        assert got.total_new_tokens < 3 * max_new


def test_generate_refuses_an_empty_budget():
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate(None, None, None, {}, prompt_len=4, max_new_tokens=0)
