"""The measured scaling matrix (``bench/suites/scaling_matrix.py``)
against ``benchmarks/bench_scaling_matrix.py``:

* from the same step-time samples, every scenario gives the reference's
  record names and derived values (``shard_balance``, ``allocation``,
  ``stage_balance``, ``max_stage`` and the rest);
* a real run on 1, 2 and 4 gloo ranks gives ``efficiency``,
  ``collective_frac`` and ``shard_balance`` in the ranges the reference's
  ``scaling-efficiency`` check holds them to (its timing gates, the PP
  model band and ordering, are for runs on cards);
* on the card, a point needing more cards than the machine has is named
  as not run.
"""
import pytest
import torch

import benchmarks.bench_scaling_matrix as ref
from repro_torch.bench import Workload
from repro_torch.bench.scenario import REGISTRY
from repro_torch.bench.suites import scaling_matrix as sm
from repro_torch.trace import Trace

SCENARIOS = ("scaling_matrix/dp", "scaling_matrix/tp",
             "scaling_matrix/mixed", "scaling_matrix/pp")


def _samples(split: str, i: int = 0) -> list:
    """Made-up step times of a split, different for every split."""
    base = 1e-3 * (1 + sum(map(int, split.replace("x", "-").split("-"))))
    return [base * (1 + 0.01 * k + 0.001 * i) for k in range(5)]


def _records(scen_fns, device=None):
    out = []
    for name in SCENARIOS:
        scen = scen_fns[name]
        for wl in scen.workloads:
            if device:
                wl = Workload(label=wl.label, arch=wl.arch,
                              knobs={**wl.knobs, "device": device})
            out.extend(scen.fn(wl))
    return out


def test_records_equal_the_references_from_the_same_samples(monkeypatch):
    import benchmarks.bench_scaling_matrix  # noqa: F401  (JAX registry)
    from repro.bench.scenario import REGISTRY as JAX_REGISTRY

    def ref_mesh(n):
        out = {"x".join(map(str, s)): {"samples_s": _samples(
            "x".join(map(str, s)))} for s in ref.SPLITS[n]}
        out["meta"] = {"heads": 4, "kv_heads": 4, "batch": 8, "seq": 64}
        return out

    def ref_pp():
        return {"-".join(map(str, sl)): {"samples_s": _samples(
            "-".join(map(str, sl)), 1)} for sl in ref.PP_STAGE_SPLITS}

    def port_mesh(n, device):
        return {"x".join(map(str, s)): Trace(
            name="t", mesh="x".join(map(str, s)),
            samples_s=_samples("x".join(map(str, s))),
            meta={"heads": 4, "batch": 8}) for s in sm.SPLITS[n]}

    def port_pp(device):
        return {k: v["samples_s"] for k, v in ref_pp().items()}

    monkeypatch.setattr(ref, "_mesh_results", ref_mesh)
    monkeypatch.setattr(ref, "_pp_results", ref_pp)
    monkeypatch.setattr(sm, "mesh_traces", port_mesh)
    monkeypatch.setattr(sm, "pp_results", port_pp)
    for name in SCENARIOS:
        assert [w.label for w in REGISTRY[name].workloads] == \
            [w.label for w in JAX_REGISTRY[name].workloads]
    want = _records(JAX_REGISTRY)
    got = _records(REGISTRY, device="cpu")
    assert [r.name for r in got] == [r.name for r in want]
    assert len(got) == 4 + 3 + 2 + 3
    for g, w in zip(got, want):
        assert g.mesh == w.mesh
        shared = set(w.derived) & set(g.derived)
        assert shared == set(w.derived), g.name
        for k in shared:
            assert g.derived[k] == w.derived[k], (g.name, k)
        assert float(g.us_per_call) == float(w.us_per_call), g.name
    pp = [r for r in got if "/pp_" in r.name]
    assert [r.derived["max_stage"] for r in pp] == [2, 3, 5]


@pytest.fixture(scope="module")
def real_records():
    """dp1, dp2, dp4, tp2 and tp4 on gloo ranks (the reference's grid)."""
    sm.mesh_traces.cache_clear()
    recs = []
    for n in (1, 2, 4):
        wl = Workload(label=f"n{n}", knobs={"devices": n, "device": "cpu"})
        recs.extend(REGISTRY["scaling_matrix/dp"].fn(wl))
        if n > 1:
            recs.extend(REGISTRY["scaling_matrix/tp"].fn(wl))
    return recs


def test_a_real_cpu_run_lies_in_the_references_ranges(real_records):
    names = [r.name for r in real_records]
    assert names == ["scaling_matrix/dp1", "scaling_matrix/dp2",
                     "scaling_matrix/tp2", "scaling_matrix/dp4",
                     "scaling_matrix/tp4"]
    for r in real_records:
        d = r.derived
        assert 0 < d["efficiency"] <= 4.0, r.name
        assert 0 <= d["collective_frac"] < 1, r.name
        assert 0 <= d["shard_balance"] <= 1, r.name
        assert d["backend"] == "gloo" and d["tok_s"] > 0
    dp1 = real_records[0].derived
    assert dp1["efficiency"] == 1.0 and dp1["collective_frac"] == 0.0


def test_the_matrix_traces_count_their_collectives(real_records):
    """The traces behind the records: the 1x1 step moves no link bytes,
    a split one counts its all-reduces with the group's size."""
    one = sm.mesh_traces(1, "cpu")["1x1"]
    assert one.meta["ici_bytes"] == 0.0
    tp2 = sm.mesh_traces(2, "cpu")["1x2"]
    assert tp2.meta["ici_bytes"] > 0 and tp2.meta["split"] == [1, 2]
    assert {"flash_attention_lse", "rmsnorm"} <= set(tp2.meta["kernels"])


def test_points_wider_than_the_cards_are_named_not_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rec = sm._split_record("dp", (2, 1), 2, "cuda")
    assert rec.name == "scaling_matrix/dp2"
    assert rec.derived == {"not_run": "needs 2 cards; this machine has 1",
                           "ranks": 2}
    assert sm.cards_missing(1, "cuda") is None
    assert sm.cards_missing(8, "cpu") is None
    assert sm.grid("cuda") == dict(reduce_kw={}, num_layers=2, batch=8,
                                   seq=1024, iters=3, warmup=1)
    assert sm.tokens("cuda") == 8192
