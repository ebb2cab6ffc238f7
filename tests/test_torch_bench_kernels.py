"""The port's ``kernels/*`` and ``scalability/*`` suites on the CPU
(``python -m repro_torch.bench --device cpu``): the scenarios are
listed; the plain and library workloads at the reference's shapes run and
carry the kernel's work and their error against the plain version; the
kernel workloads (and the card's ``path`` shapes) are not run on the CPU
and say so, with no time; one small gloo point of the scalability sweep
(``dp2``) runs and reports its throughput.
"""
import dataclasses

import pytest

from repro_torch.bench import BenchRunner, ListSink, read_jsonl, select
from repro_torch.bench.__main__ import main, with_device
from repro_torch.kernels import work

KERNEL_SCENARIOS = ["kernels/attention", "kernels/wkv6", "kernels/rmsnorm"]
SCAL_SCENARIOS = ["scalability/dp", "scalability/tp",
                  "scalability/streaming", "scalability/pp"]


def test_suites_list(capsys):
    assert main(["--device", "cpu", "--only", "kernels,scalability",
                 "--list"]) == 0
    out = capsys.readouterr().out
    for name in KERNEL_SCENARIOS + SCAL_SCENARIOS:
        assert name in out


@pytest.fixture(scope="module")
def kernel_records(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "k.jsonl"
    assert main(["--device", "cpu", "--only", "kernels", "--json",
                 str(path)]) == 0
    return {r.name: r for r in read_jsonl(path)}


def test_kernel_workloads_not_run_on_the_cpu(kernel_records):
    recs = kernel_records
    assert len(recs) == 18
    for name, r in recs.items():
        cpu_runs = "_kernel_" not in name and name.endswith("_ref")
        if cpu_runs:
            assert "not_run" not in r.derived and r.us_per_call > 0, name
        else:
            assert r.derived["not_run"] and r.us_per_call == 0, name
            assert "max_abs_err" not in r.derived and not r.samples_us
        assert r.status == "ok" and r.derived["device"] == "cpu"


def test_records_carry_work_and_error(kernel_records):
    import torch

    recs = kernel_records
    q = torch.empty(1, 512, 4, 64)
    k = torch.empty(1, 512, 2, 64)
    w = work.flash_forward(q, k, causal=True, window=0)
    for impl in ("plain", "kernel", "library"):
        r = recs[f"kernels/attn_{impl}_ref"]
        assert (r.derived["flops"], r.derived["bytes"]) == (w.flops, w.bytes)
    w = work.rmsnorm(4096, 512, 4)
    assert recs["kernels/rmsnorm_plain_ref"].derived["flops"] == w.flops
    assert recs["kernels/attn_plain_ref"].derived["max_abs_err"] == 0
    assert recs["kernels/attn_library_ref"].derived["max_abs_err"] < 1e-5
    assert recs["kernels/rmsnorm_library_ref"].derived["max_abs_err"] < 1e-5
    assert recs["kernels/wkv6_chunked_ref"].derived["rel_err"] < 1e-4
    assert recs["kernels/wkv6_plain_ref"].derived["flops"] > 0


def test_scalability_dp2_on_gloo_ranks():
    scen = [with_device(s, "cpu") for s in select(only="scalability/dp")]
    scen = [dataclasses.replace(s, workloads=tuple(
        dataclasses.replace(w, knobs={**w.knobs, "points": ("dp2",),
                                      "timeout": 240})
        for w in s.workloads)) for s in scen]
    sink = ListSink()
    summary = BenchRunner(sinks=[sink]).run(scen)
    assert not summary.failures, summary.failures
    (rec,) = sink.records
    assert rec.name == "scalability/dp2" and rec.status == "ok"
    assert rec.us_per_call > 0
    assert rec.derived["ranks"] == 2 and rec.derived["backend"] == "gloo"
    assert rec.derived["tok_s"] == round(16 * 128 / (rec.us_per_call * 1e-6))
