"""The readers of the program's spans (``cardbench/spans.py`` and the
three metrics that use it) on hand-made traces: the card's busy time
clipped to a span, spans cut by the window's edges left out, nothing read
without device events or without a whole span; and a traced toy run on
the CPU, whose trace holds the program's optimizer span among its host
events."""
from __future__ import annotations

import pytest

from cardbench import harness, spans
from cardbench import trace as trace_mod
from cardbench.conftest import REPO, run_toy
from cardbench.trace import Trace

DECODE = "repro_torch.serve.decode_step"
CHUNK = "repro_torch.serve.prefill_chunk"
UPDATE = "repro_torch.train.optimizer"


def _read(name: str, trace) -> float:
    return harness.reader(REPO, name)({"trace": trace, "counts": {}})


def _serving_trace() -> Trace:
    """A window that opens inside one decode step (its span not recorded)
    and closes inside another (its span closed at the stop, at 100): two
    whole steps, 10-30 and 60-80, and a prefill chunk between them."""
    host = [("aten::mm", 2, 4),
            (DECODE, 10, 30), ("aten::mm", 12, 20),
            (CHUNK, 35, 55),
            (DECODE, 60, 80),
            (DECODE, 85, 100), ("aten::mm", 88, 90)]
    device = [("gemm", 3, 6), ("gemm", 12, 18), ("gemm", 16, 22),
              ("paged_decode_kernel", 25, 40), ("gemm", 40, 50),
              ("gemm", 61, 71), ("gemm", 89, 95)]
    return Trace(device, host, 1.0, {"decode": 3, "prefill": 1})


def test_busy_time_is_clipped_to_each_interval():
    tr = _serving_trace()
    got = spans.busy_s(tr, [(10, 30), (60, 80), (0, 5), (96, 99)])
    # 12-22 and 25-30; 61-71; 3-5; nothing
    assert got == pytest.approx([15e-9, 10e-9, 2e-9, 0.0])


def test_spans_cut_by_the_windows_edges_are_left_out():
    tr = _serving_trace()
    assert spans.whole(tr, DECODE) == [(10, 30), (60, 80)]
    assert spans.whole(tr, CHUNK) == [(35, 55)]
    # a span that is the window's first event has nothing before it
    first = Trace([], [(UPDATE, 1, 5), ("aten::add", 2, 3),
                       (UPDATE, 6, 9), ("aten::item", 10, 11)], 1.0)
    assert spans.whole(first, UPDATE) == [(6, 9)]
    assert spans.whole(Trace([], [], 1.0), UPDATE) == []


def test_the_serving_readers_on_a_hand_made_window():
    tr = _serving_trace()
    assert _read("decode_busy_ms.serve", tr) == pytest.approx(
        1e3 * (15e-9 + 10e-9) / 2)
    assert _read("prefill_stall_ms.serve", tr) == pytest.approx(
        1e-6 * 20 / 2)


def test_the_optimizer_reader_on_a_hand_made_step():
    host = [("aten::mm", 0, 5), ("repro_torch.train.loss_read", 5, 20),
            (UPDATE, 20, 40), ("aten::item", 41, 42)]
    device = [("gemm", 1, 19), ("vectorized_elementwise_kernel", 21, 30),
              ("vectorized_elementwise_kernel", 28, 35)]
    tr = Trace(device, host, 1.0, {"steps": 1})
    assert _read("optimizer_ms.train", tr) == pytest.approx(1e3 * 14e-9)


@pytest.mark.parametrize("name", ["decode_busy_ms.serve",
                                  "prefill_stall_ms.serve",
                                  "optimizer_ms.train"])
def test_no_device_events_or_no_whole_span_reads_nothing(name):
    tr = _serving_trace()
    assert _read(name, None) is None
    assert _read(name, Trace([], tr.host, 1.0)) is None
    # a program without the spans, as the benchmark's parent side may be
    bare = Trace(tr.device, [ev for ev in tr.host
                             if not ev[0].startswith("repro_torch.")], 1.0)
    assert _read(name, bare) is None


def test_a_traced_toy_run_holds_the_programs_optimizer_span(toy_root,
                                                            monkeypatch):
    kept = []
    stop = trace_mod.Tracer.stop

    def keep(self, **counts):
        kept.append(stop(self, **counts))
        return kept[-1]

    monkeypatch.setattr(trace_mod.Tracer, "stop", keep)
    line = run_toy(toy_root, "toy-dense.train", trace=1)
    assert line["correct"], line["checks"]
    tr, = kept
    steps = tr.counts["steps"]
    assert len(spans.whole(tr, UPDATE)) == steps
    names = {n for n, _, _ in tr.host}
    assert {"repro_torch.train.forward", "repro_torch.train.backward",
            "repro_torch.train.loss_read", "repro_torch.model.attention",
            "repro_torch.model.mlp", "repro_torch.model.head"} <= names
    # no device events on the CPU: the readers of the spans read nothing
    assert "optimizer_ms.train" not in line["metrics"]
