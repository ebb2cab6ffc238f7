"""The port's spans (``repro_torch.core.spans``) on the CPU: nothing is
recorded outside a profiler; under ``torch.profiler`` a toy paged-engine
run and a toy training step record each span as often as the work it
brackets happened, as plain ``cpu_op`` ranges (never user annotations,
which kineto would mirror onto the device), nested as the layers nest;
the profiler changes no greedy token; and every span the port opens is
registered in ``NAMES``."""
import ast
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import spans
from repro_torch.core.spans import NAMES, span
from repro_torch.data.pipeline import synth_requests
from repro_torch.launch.serve import build_engine
from repro_torch.launch.train import build_trainer
from repro_torch.serving import SimClock

torch.set_num_threads(2)
ARCH = "granite-3-8b"
REDUCE = dict(layers=2, d_model=64, vocab=128, d_ff=128)
PROMPT, BUDGET, LANES, PS = 8, 6, 4, 8
# a request needs pages_needed(8 + 6, 8) = 2 pages: the roomy pool holds
# every lane's, the tight one two requests' at a time
POOLS = {"roomy": None, "tight": 1 + 2 * 2}
SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _engine(num_pages=None):
    return build_engine(ARCH, batch=LANES, prompt_len=PROMPT,
                        max_new_tokens=BUDGET, scheduler="paged",
                        reduce_kw=REDUCE, clock=SimClock(), page_size=PS,
                        num_pages=num_pages, prefill_chunk_tokens=PROMPT // 2,
                        device="cpu")


def _requests(cfg):
    return synth_requests(cfg, 8, PROMPT, max_new_tokens=(2, BUDGET, 3))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("repro_torch.")]
    return out, events


def _by_name(events) -> dict:
    out = {}
    for e in events:
        out.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    return {n: sorted(v) for n, v in out.items()}


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_outside_a_profiler_a_span_records_nothing():
    a = span("repro_torch.serve.decode_step")
    assert a is span("repro_torch.model.head") is spans._NULL
    with a:
        # a span entered before the profiler starts stays a null context
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(4).sum()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not {n for n in names if n.startswith("repro_torch.")}


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_a_profiled_paged_run_records_each_span_as_its_work_happened(pool):
    eng, cfg = _engine(POOLS[pool])
    report, events = _profiled(lambda: eng.run(_requests(cfg)))
    got = _by_name(events)
    count = {n: len(v) for n, v in got.items()}
    assert report.completed == 8
    assert count["repro_torch.serve.decode_step"] == report.decode_steps
    assert count["repro_torch.serve.retire"] == report.decode_steps
    assert count["repro_torch.serve.prefill_chunk"] == report.prefills
    # one admit span an admission attempt: a refused reservation ends one
    assert (pool == "tight") == (report.admission_blocked_steps > 0)
    assert count["repro_torch.serve.admit"] == \
        report.handoffs + report.admission_blocked_steps
    assert report.handoffs == 8
    for e in events:
        assert e.activity_type() == "cpu_op", e.name()
        assert not e.is_user_annotation(), e.name()
    steps = got["repro_torch.serve.decode_step"]
    chunks = got["repro_torch.serve.prefill_chunk"]
    attention = got["repro_torch.model.attention"]
    for outer in steps + chunks:
        inner = [a for a in attention if _inside(a, outer)]
        assert len(inner) == REDUCE["layers"], outer
    assert len(attention) == REDUCE["layers"] * (len(steps) + len(chunks))
    for name in ("repro_torch.model.mlp", "repro_torch.model.head",
                 "repro_torch.kernels.rmsnorm"):
        assert all(any(_inside(s, o) for o in steps + chunks)
                   for s in got[name]), name
    k2 = got["repro_torch.kernels.paged_attention"]
    assert len(k2) == REDUCE["layers"] * len(steps)
    assert all(any(_inside(k, a) for a in attention) for k in k2)
    admits = got["repro_torch.serve.admit"]
    assert all(any(_inside(c, a) for a in admits) for c in chunks)


def test_greedy_tokens_are_the_same_with_the_profiler_on_and_off():
    eng, cfg = _engine()
    plain = eng.run(_requests(cfg))
    traced, events = _profiled(lambda: eng.run(_requests(cfg)))
    assert events
    assert {m.rid: list(m.tokens) for m in traced.metrics} == \
        {m.rid: list(m.tokens) for m in plain.metrics}


def test_a_profiled_training_step_records_its_phases_in_order():
    step, p, o, data, rcfg = build_trainer(
        ARCH, steps=4, batch=2, seq=16, microbatches=2,
        reduce_kw=dict(layers=2, d_model=64), device="cpu")
    (_, _, m), events = _profiled(lambda: step(p, o, data.batch_at(0)))
    got = _by_name(events)
    count = {n: len(v) for n, v in got.items()}
    assert count["repro_torch.train.loss_read"] == 1
    assert count["repro_torch.train.optimizer"] == 1
    assert count["repro_torch.train.forward"] == rcfg.microbatches == 2
    assert count["repro_torch.train.backward"] == 2
    read = got["repro_torch.train.loss_read"][0]
    update = got["repro_torch.train.optimizer"][0]
    assert read[1] <= update[0]
    phases = sorted(got["repro_torch.train.forward"]
                    + got["repro_torch.train.backward"])
    assert phases[-1][1] <= read[0]
    for f, b in zip(got["repro_torch.train.forward"],
                    got["repro_torch.train.backward"]):
        assert f[1] <= b[0]
    heads = got["repro_torch.model.head"]
    assert len(heads) == 2 and all(
        any(_inside(h, f) for f in got["repro_torch.train.forward"])
        for h in heads)
    assert torch.isfinite(m["loss"])


def _span_names(path: Path) -> list:
    """(line, first argument) of every ``span(...)`` call in ``path``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "span":
            arg = node.args[0] if node.args else None
            out.append((node.lineno, arg.value if isinstance(
                arg, ast.Constant) else None))
    return out


def test_every_span_the_port_opens_is_registered():
    used = {}
    for path in sorted(SRC.rglob("*.py")):
        for line, name in _span_names(path):
            where = f"{path.relative_to(SRC)}:{line}"
            assert name in NAMES, f"{where} opens {name!r}"
            used.setdefault(name, []).append(where)
    assert set(used) == set(NAMES), set(NAMES) - set(used)
    assert all(n.startswith("repro_torch.") for n in NAMES)
    with pytest.raises(KeyError):
        span("repro_torch.serve.nothing")


def test_the_fast_record_function_exists():
    """A torch without it would leave the port with no spans at all."""
    assert callable(torch._C._profiler._RecordFunctionFast)
    assert callable(torch._C._autograd._profiler_enabled)
