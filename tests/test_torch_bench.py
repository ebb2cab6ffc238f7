"""The port's benchmark harness (``repro_torch.bench``): the cases of
``tests/test_bench.py`` and ``tests/test_compare.py`` on the port's own
record, registry, runner, baselines, compare gate and CLI
(``python -m repro_torch.bench``); the port's suites against the JAX
package's (same record names and derived keys, and with the TPU's
constants injected the same values); the measured suites on a reduced
workload on the CPU; and the CLI's refusal to run without a card unless
asked for the CPU."""
from __future__ import annotations

import dataclasses
import json
import random

import pytest
import torch

import jax  # noqa: F401  (the test files import both packages)

import repro_torch.bench.__main__ as bench_main
import repro_torch.bench.suites  # noqa: F401  (registers the scenarios)
from repro_torch.bench import (CSV_HEADER, BenchRecord, BenchRunner,
                               CsvStdoutSink, JsonlSink, ListSink, Scenario,
                               TimingStats, Workload, bless, compare_record,
                               compare_records, env_fingerprint,
                               load_baselines, read_jsonl, read_trajectory,
                               register, scenario, select, unregister,
                               write_jsonl)
from repro_torch.bench.baseline import (baseline_path, blessable, fingerprint,
                                        fingerprint_compatible)
from repro_torch.bench.compare import (FASTER, NEW, NOISY, OK, REGRESSION,
                                       SKIPPED, sign_test_p)
from repro_torch.bench.scenario import REGISTRY

# ------------------------------------------------------------- record I/O
def test_record_json_round_trip():
    rec = BenchRecord(
        name="allocation/layers12/O3", scenario="allocation/layers",
        group="allocation", arch="granite-3-8b", shape="bench",
        mesh="16x16", knobs={"mode": "O3", "num_layers": 12},
        us_per_call=123.4, derived={"alloc": 0.998, "n_sections": 13},
        tags=("tier1", "table1"), paper_ref="Table I",
        env={"python": "3.10"})
    back = BenchRecord.from_json_line(rec.to_json_line())
    assert back == rec
    # derived metrics survive as a real dict, not a parsed string
    assert back.derived["alloc"] == pytest.approx(0.998)
    assert isinstance(back.derived["n_sections"], int)


def test_record_from_dict_ignores_unknown_fields():
    d = json.loads(BenchRecord(name="x").to_json_line())
    d["future_field"] = "whatever"
    assert BenchRecord.from_dict(d).name == "x"


def test_record_csv_line_format():
    rec = BenchRecord(name="deploy/batch8", us_per_call=1234.56,
                      derived={"tok_s": 829, "mfu": 0.51234})
    assert CSV_HEADER == "name,us_per_call,derived"
    assert rec.csv_line() == "deploy/batch8,1234.6,tok_s=829;mfu=0.5123"


def test_jsonl_file_round_trip(tmp_path):
    recs = [BenchRecord(name=f"g/s{i}", us_per_call=float(i),
                        derived={"m": i}) for i in range(3)]
    path = write_jsonl(recs, tmp_path / "out" / "r.jsonl")
    assert read_jsonl(path) == recs


# ----------------------------------------------------------- timing stats
def test_timing_stats_is_a_float_mean_with_percentiles():
    ts = TimingStats([10.0, 20.0, 30.0, 40.0, 100.0])
    assert float(ts) == pytest.approx(40.0)      # drops in as the mean
    assert ts == pytest.approx(40.0)
    assert ts.p50_us == pytest.approx(30.0)
    assert ts.p95_us == pytest.approx(88.0)      # interpolated
    assert ts.samples == (10.0, 20.0, 30.0, 40.0, 100.0)


def test_runner_stamps_percentiles_from_timing_stats():
    scen = Scenario(
        name="_test/p50",
        fn=lambda wl: [BenchRecord(
            name="_test/p50/r",
            us_per_call=TimingStats([1.0, 2.0, 9.0]))],
        group="_test", workloads=(Workload(),))
    rec = BenchRunner().run([scen]).records[0]
    assert rec.us_per_call == pytest.approx(4.0)
    assert type(rec.us_per_call) is float         # stripped for JSON
    assert rec.p50_us == pytest.approx(2.0)
    assert rec.p95_us == pytest.approx(8.3)
    # percentiles survive the JSONL round trip; the CSV is unchanged
    back = BenchRecord.from_json_line(rec.to_json_line())
    assert back.p50_us == rec.p50_us and back.p95_us == rec.p95_us
    assert rec.csv_line() == "_test/p50/r,4.0,"


# --------------------------------------------------------------- registry
@pytest.fixture
def scratch_registry():
    """Track scenario names registered inside a test; always unregister."""
    added = []
    yield added
    for name in added:
        unregister(name)


def test_scenario_decorator_registers(scratch_registry):
    @scenario("_test/basic", tags=("unit",), paper_ref="Fig. 0",
              workloads=[Workload(label="a"), Workload(label="b")])
    def fn(wl):
        yield BenchRecord(name=f"_test/{wl.label}")

    scratch_registry.append("_test/basic")
    scen = REGISTRY["_test/basic"]
    assert scen.group == "_test"
    assert scen.tags == ("unit",)
    assert len(scen.workloads) == 2


def test_duplicate_registration_rejected(scratch_registry):
    register(Scenario(name="_test/dup", fn=lambda wl: [], group="_test"))
    scratch_registry.append("_test/dup")
    with pytest.raises(ValueError, match="already registered"):
        register(Scenario(name="_test/dup", fn=lambda wl: [],
                          group="_test"))


def test_select_filters_by_substring_and_tags(scratch_registry):
    for name, tags in [("_test/aaa", ("red",)), ("_test/bbb", ("blue",))]:
        register(Scenario(name=name, fn=lambda wl: [], group="_test",
                          tags=tags))
        scratch_registry.append(name)
    assert [s.name for s in select(only="_test/a")] == ["_test/aaa"]
    assert [s.name for s in select(only="_test", tags=["blue"])] \
        == ["_test/bbb"]
    assert [s.name for s in select(only="_test/nope")] == []


def test_select_exact_name_beats_substring(scratch_registry):
    """An --only term that exactly names a scenario selects just it (the
    CI flaky-retry path), even when it is a substring of siblings; comma
    lists union their terms."""
    for name in ["_test/sched", "_test/sched_static", "_test/other"]:
        register(Scenario(name=name, fn=lambda wl: [], group="_test"))
        scratch_registry.append(name)
    # substring term: matches both sched scenarios
    assert [s.name for s in select(only="sched")] \
        == ["_test/sched", "_test/sched_static"]
    # exact term: only the named scenario, not its prefix-sharing sibling
    assert [s.name for s in select(only="_test/sched")] == ["_test/sched"]
    assert [s.name for s in select(only="_test/sched,_test/other")] \
        == ["_test/sched", "_test/other"]


# ----------------------------------------------------------------- runner
def _tiny_scenarios():
    ok = Scenario(
        name="_test/ok",
        fn=lambda wl: [BenchRecord(name=f"_test/ok/{wl.label}",
                                   us_per_call=1.0,
                                   derived={"x": wl.knobs["x"]})],
        group="_test", tags=("unit",), paper_ref="Fig. 0",
        workloads=(Workload(label="w0", arch="granite-3-8b",
                            knobs={"x": 7}),))

    def boom(wl):
        raise RuntimeError("kaboom")
        yield  # pragma: no cover

    bad = Scenario(name="_test/boom", fn=boom, group="_test",
                   workloads=(Workload(label="w0"),))
    return ok, bad


def test_runner_end_to_end_with_sinks(tmp_path, capsys):
    ok, bad = _tiny_scenarios()
    jsonl = tmp_path / "r.jsonl"
    sink = ListSink()
    summary = BenchRunner(
        sinks=[CsvStdoutSink(), JsonlSink(jsonl), sink]).run([ok, bad])

    # fail-soft: the bad scenario is captured, the sweep completes
    assert [n for n, _ in summary.failures] == ["_test/boom/w0"]
    assert not summary.ok

    good = [r for r in summary.records if r.status == "ok"]
    errs = [r for r in summary.records if r.status == "error"]
    assert len(good) == 1 and len(errs) == 1
    # provenance stamped from scenario + workload
    rec = good[0]
    assert rec.scenario == "_test/ok" and rec.group == "_test"
    assert rec.arch == "granite-3-8b" and rec.tags == ("unit",)
    assert rec.knobs == {"x": 7} and rec.env
    assert "kaboom" in errs[0].error

    # every sink saw every record
    assert sink.records == summary.records
    assert read_jsonl(jsonl) == summary.records
    out = capsys.readouterr().out.splitlines()
    assert out[0] == CSV_HEADER
    assert out[1] == "_test/ok/w0,1.0,x=7"


def test_runner_scenario_timeout_records_and_continues(monkeypatch):
    """A hung workload becomes a ``status: "timeout"`` record and the
    sweep still runs the scenarios after it (S-curve soak runs must not
    wedge the whole matrix behind one deadlocked cell)."""
    import time as _time

    def hang(wl):
        _time.sleep(30.0)
        yield BenchRecord(name="_test/hang/never")  # pragma: no cover

    hung = Scenario(name="_test/hang", fn=hang, group="_test",
                    workloads=(Workload(label="w0"),))
    ok, _ = _tiny_scenarios()
    summary = BenchRunner(timeout_s=0.2).run([hung, ok])

    assert [n for n, _ in summary.failures] == ["_test/hang/w0"]
    timeouts = [r for r in summary.records if r.status == "timeout"]
    assert len(timeouts) == 1
    assert timeouts[0].name == "_test/hang/w0/TIMEOUT"
    assert timeouts[0].derived["timeout_s"] == 0.2
    assert "0s budget" in timeouts[0].error
    # the sweep continued past the hang
    assert [r.name for r in summary.records if r.status == "ok"] \
        == ["_test/ok/w0"]
    # env override feeds the default budget
    monkeypatch.setenv("REPRO_SCENARIO_TIMEOUT_S", "7.5")
    assert BenchRunner().timeout_s == 7.5


def test_runner_timeout_disarmed_after_workload():
    """The alarm is always cancelled — a fast workload must not leave a
    pending SIGALRM to kill unrelated code later."""
    import signal as _signal

    ok, _ = _tiny_scenarios()
    BenchRunner(timeout_s=0.05).run([ok])
    assert _signal.getitimer(_signal.ITIMER_REAL) == (0.0, 0.0)


def test_runner_record_knobs_override_workload_knobs():
    scen = Scenario(
        name="_test/knobs",
        fn=lambda wl: [BenchRecord(name="_test/knobs/r",
                                   knobs={"mode": "O3"})],
        group="_test", workloads=(Workload(knobs={"mode": "O0", "L": 4}),))
    summary = BenchRunner().run([scen])
    assert summary.records[0].knobs == {"mode": "O3", "L": 4}


ENV = {"python": "3.12.3", "platform": "linux", "machine": "x86_64",
       "torch": "2.13.0", "backend": "cpu"}


def rec(name="g/s", us=1000.0, samples=None, env=ENV, status="ok",
        p50=0.0):
    samples = list(samples or [])
    return BenchRecord(name=name, group="g", us_per_call=us, p50_us=p50,
                       samples_us=samples, status=status, env=dict(env))


# ------------------------------------------------------- baseline store
def test_baseline_bless_and_load_round_trip(tmp_path):
    records = [rec("g/a", us=100.0, samples=[90, 100, 110]),
               rec("g/b", us=200.0)]
    written = bless(records, tmp_path)
    assert set(written) == {"cpu"}
    assert written["cpu"] == baseline_path(tmp_path, "cpu")
    back = load_baselines(tmp_path, "cpu")
    assert set(back) == {"g/a", "g/b"}
    assert back["g/a"].samples_us == [90, 100, 110]
    assert load_baselines(tmp_path, "cuda") == {}  # never blessed


def test_bless_overwrites_by_name_and_keeps_others(tmp_path):
    bless([rec("g/a", us=100.0), rec("g/keep", us=50.0)], tmp_path)
    bless([rec("g/a", us=300.0)], tmp_path)  # re-bless one name
    back = load_baselines(tmp_path, "cpu")
    assert back["g/a"].us_per_call == 300.0   # overwritten
    assert back["g/keep"].us_per_call == 50.0  # untouched


def test_blessable_excludes_error_and_untimed_records():
    keep = rec("g/a", us=100.0)
    out = blessable([keep, rec("g/err", us=100.0, status="error"),
                     rec("g/analytic", us=0.0)])
    assert out == [keep]


def test_fingerprint_compatibility_rules():
    assert fingerprint_compatible(fingerprint(ENV), fingerprint(ENV))
    other = dict(ENV, torch="2.14.0")
    assert not fingerprint_compatible(fingerprint(ENV), fingerprint(other))
    # a key missing on one side never counts as a mismatch
    sparse = {"backend": "cpu"}
    assert fingerprint_compatible(sparse, fingerprint(ENV))


# ------------------------------------------------------------ verdicts
def test_compare_statuses_ok_new_faster():
    base = rec(us=1000.0)
    assert compare_record(rec(us=1000.0), base).status == OK
    assert compare_record(rec(us=1100.0), base).status == OK  # within tol
    assert compare_record(rec(us=100.0), base).status == FASTER
    assert compare_record(rec(us=1000.0), None).status == NEW


def test_fingerprint_mismatch_skips_not_fails():
    base = rec(us=1000.0, env=dict(ENV, torch="2.14.0"))
    res = compare_record(rec(us=5000.0), base)  # 5x slower, wrong env
    assert res.status == SKIPPED
    assert "fingerprint" in res.detail
    report = compare_records([rec(us=5000.0)], {"g/s": base})
    assert report.ok  # skips never fail the gate


def test_sub_min_us_baseline_is_skipped():
    res = compare_record(rec(us=90.0), rec(us=30.0))  # 3x but noise-sized
    assert res.status == SKIPPED


def test_regression_needs_ratio_and_sign_test():
    base = rec(us=1000.0, samples=[950, 1000, 1050, 1000, 990])
    # 2x slower, every sample above the old median: regression
    slow = rec(us=2000.0, samples=[1900, 2000, 2100, 2050, 1950])
    res = compare_record(slow, base)
    assert res.status == REGRESSION
    assert res.ratio == pytest.approx(2.0)
    # mean inflated by one spike, but samples straddle the old median:
    # the sign test vetoes the ratio -> noisy, not a failure
    spiky = rec(us=1400.0, samples=[900, 950, 1000, 980, 3170])
    res = compare_record(spiky, base)
    assert res.status == NOISY
    assert compare_records([spiky], {"g/s": base}).ok


def test_unanimous_samples_regress_even_below_significance():
    """4 samples can never reach alpha=0.05 (best p = 1/16), but when
    every sample sits above the old median there is no contrary evidence
    — the unanimity clause must still fail the gate."""
    base = rec(us=1000.0, samples=[950, 1000, 1050, 1000])
    slow = rec(us=2000.0, samples=[1900, 2000, 2100, 2050])
    res = compare_record(slow, base)
    assert res.status == REGRESSION
    # one straddling sample restores the noise veto
    spiky = rec(us=1600.0, samples=[900, 2000, 2100, 3400])
    assert compare_record(spiky, base).status == NOISY


def test_regression_without_samples_needs_a_larger_ratio_breach():
    """Sample-less records have no sign-test veto, so ordinary one-shot
    jitter (25-60%) must read as noisy; only a big breach regresses."""
    res = compare_record(rec(us=2000.0), rec(us=1000.0))  # 2x
    assert res.status == REGRESSION
    assert "ratio-only" in res.detail
    res = compare_record(rec(us=1400.0), rec(us=1000.0))  # 1.4x jitter
    assert res.status == NOISY
    assert "without samples" in res.detail


def test_sign_test_p_values():
    assert sign_test_p(5, 5) == pytest.approx(1 / 32)
    assert sign_test_p(4, 5) == pytest.approx(6 / 32)
    assert sign_test_p(0, 5) == pytest.approx(1.0)
    assert sign_test_p(0, 0) == 1.0


def test_threshold_verdict_is_deterministic_under_seeded_fake_timer():
    """Same seeded fake-timer samples -> byte-identical verdicts, and a
    borderline +34% drift whose samples straddle the old median stays
    `noisy` (never flaps to regression) run after run."""
    rng = random.Random(42)
    base_samples = sorted(1000.0 + rng.gauss(0, 30) for _ in range(5))
    base = rec(us=sum(base_samples) / 5, samples=base_samples,
               p50=base_samples[2])
    drift = [s * 1.5 if i != 0 else s * 0.7
             for i, s in enumerate(base_samples)]
    fresh = rec(us=sum(drift) / 5, samples=drift)
    verdicts = [compare_record(fresh, base) for _ in range(3)]
    assert all(v.status == verdicts[0].status for v in verdicts)
    assert verdicts[0].status == NOISY
    # a genuine seeded 2x slowdown is still caught every time
    slow = rec(us=2000.0, samples=[s * 2 for s in base_samples])
    assert all(compare_record(slow, base).status == REGRESSION
               for _ in range(3))


def test_compare_uses_p50_over_mean_when_available():
    base = rec(us=5000.0, p50=1000.0)
    fresh = rec(us=1000.0, p50=1000.0)
    res = compare_record(fresh, base)
    assert res.status == OK and res.ratio == pytest.approx(1.0)


# ------------------------------------------------- report + trajectory
def test_report_counts_geomean_and_trajectory(tmp_path):
    from repro_torch.bench import append_trajectory

    base = {"g/a": rec("g/a", us=1000.0), "g/b": rec("g/b", us=1000.0)}
    report = compare_records(
        [rec("g/a", us=2000.0), rec("g/b", us=500.0), rec("g/new")],
        base)
    assert [r.name for r in report.regressions] == ["g/a"]
    c = report.counts()
    assert c[REGRESSION] == 1 and c[FASTER] == 1 and c[NEW] == 1
    assert report.geomean_ratio() == pytest.approx(1.0)  # 2.0 * 0.5
    traj = tmp_path / "trajectory.jsonl"
    append_trajectory(report.trajectory_point(extra={"git": "abc123"}),
                      traj)
    append_trajectory(report.trajectory_point(), traj)
    points = read_trajectory(traj)
    assert len(points) == 2
    assert points[0]["git"] == "abc123"
    assert points[0]["regressions"] == ["g/a"]
    assert points[0]["compared"] == 2


def test_runner_stamps_samples_us_from_timing_stats():
    scen = Scenario(
        name="_test/samples",
        fn=lambda wl: [BenchRecord(
            name="_test/samples/r",
            us_per_call=TimingStats([1.0, 2.0, 9.0]))],
        group="_test", workloads=(Workload(),))
    out = BenchRunner().run([scen]).records[0]
    assert out.samples_us == [1.0, 2.0, 9.0]
    back = BenchRecord.from_json_line(out.to_json_line())
    assert back.samples_us == [1.0, 2.0, 9.0]


# --------------------------------------------------------- CLI plumbing
def _cli(tmp_path, jsonl, *extra):
    return bench_main.main([
        "--compare-only", "--json", str(jsonl),
        "--baseline-dir", str(tmp_path / "baselines"),
        "--trajectory", str(tmp_path / "trajectory.jsonl"), *extra])


def test_cli_bless_then_compare_then_injected_slowdown(tmp_path, capsys):
    jsonl = tmp_path / "latest.jsonl"
    records = [rec("g/a", us=1000.0, samples=[950, 1000, 1050, 990, 1010]),
               rec("g/b", us=400.0)]
    write_jsonl(records, jsonl)

    assert _cli(tmp_path, jsonl, "--bless") == 0
    assert load_baselines(tmp_path / "baselines", "cpu").keys() \
        == {"g/a", "g/b"}
    assert _cli(tmp_path, jsonl) == 0          # clean re-run passes

    _inject_slowdown(jsonl, 2.0)
    assert read_jsonl(jsonl)[0].us_per_call == pytest.approx(2000.0)
    assert _cli(tmp_path, jsonl) == 3          # the gate trips
    err = capsys.readouterr().err
    assert "PERFORMANCE REGRESSION" in err
    # blessing the slowdown accepts it as the new baseline
    assert _cli(tmp_path, jsonl, "--bless") == 0
    assert _cli(tmp_path, jsonl) == 0
    points = read_trajectory(tmp_path / "trajectory.jsonl")
    assert len(points) == 5
    assert points[2]["regressions"] == ["g/a", "g/b"]


def test_cli_compare_only_without_records_errors(tmp_path):
    assert _cli(tmp_path, tmp_path / "missing.jsonl") == 2


def test_cli_compares_per_backend_without_shadowing(tmp_path):
    """Names repeat across backends; a cpu record must be diffed against
    the cpu baseline even when a cuda baseline of the same name exists
    (a flattened name-keyed dict would shadow it into a fingerprint
    skip and silently pass a real regression)."""
    jsonl = tmp_path / "latest.jsonl"
    card = rec("g/a", us=2000.0, env=dict(ENV, backend="cuda"))
    write_jsonl([rec("g/a", us=1000.0), card], jsonl)
    assert _cli(tmp_path, jsonl, "--bless") == 0
    assert set(load_baselines(tmp_path / "baselines", "cuda")) == {"g/a"}
    # cpu regresses 3x, cuda unchanged
    write_jsonl([rec("g/a", us=3000.0), card], jsonl)
    assert _cli(tmp_path, jsonl) == 3


def test_runner_sample_cap_strides_over_the_whole_run():
    """The 64-sample cap must subsample the full chronological sequence,
    not keep a head slice — a late-run degradation tail has to stay
    visible to the compare sign test."""
    samples = [100.0] * 60 + [500.0] * 60
    scen = Scenario(
        name="_test/cap",
        fn=lambda wl: [BenchRecord(name="_test/cap/r",
                                   us_per_call=TimingStats(samples))],
        group="_test", workloads=(Workload(),))
    out = BenchRunner().run([scen]).records[0]
    assert len(out.samples_us) == 64
    assert out.samples_us[0] == 100.0
    assert out.samples_us[-1] == 500.0
    assert sum(1 for s in out.samples_us if s == 500.0) >= 30


def _inject_slowdown(path, factor):
    """Every timing of the JSONL at ``path`` times ``factor``."""
    recs = read_jsonl(path)
    for r in recs:
        r.us_per_call *= factor
        r.p50_us *= factor
        r.p95_us *= factor
        r.samples_us = [s * factor for s in r.samples_us]
    write_jsonl(recs, path)


# --------------------------------------------- the port's suites and CLI
STRUCTURAL = ("allocation/layers", "allocation/hidden", "allocation/archs",
              "load_balance/layers", "load_balance/hidden")


def test_suites_register_every_group():
    from repro_torch.bench import groups
    assert {"allocation", "load_balance", "efficiency", "roofline"} <= \
        set(groups())
    assert [s.name for s in select(only="measured")] == [
        "efficiency/measured", "roofline/measured"]


@pytest.mark.parametrize("name", STRUCTURAL)
def test_structural_suites_equal_the_jax_suites(name):
    """Same workloads, record names, knobs and derived keys as the JAX
    suite it ports; with the TPU's constants the same values too."""
    import benchmarks.bench_allocation  # noqa: F401  (JAX registry)
    import benchmarks.bench_load_balance  # noqa: F401
    from repro.bench.scenario import REGISTRY as JAX_REGISTRY

    jax_scen, scen = JAX_REGISTRY[name], REGISTRY[name]
    assert [w.label for w in scen.workloads] == \
        [w.label for w in jax_scen.workloads]
    from test_torch_metrics import TPU as tpu
    for wl, jwl in zip(scen.workloads, jax_scen.workloads):
        assert dict(wl.knobs) == dict(jwl.knobs)
        got = list(scen.fn(wl, chip=tpu))
        want = list(jax_scen.fn(jwl))
        assert [(r.name, r.knobs, r.derived) for r in got] == \
            [(r.name, r.knobs, r.derived) for r in want]
        # with the H100's constants: the same records, H100 values
        h100 = list(scen.fn(wl))
        assert [(r.name, sorted(r.derived)) for r in h100] == \
            [(r.name, sorted(r.derived)) for r in want]


def _reduced(name, **knobs):
    scen = REGISTRY[name]
    wl = Workload(label="reduced2", arch="granite-3-8b", knobs={
        "num_layers": 2, "batch": 1, "seq": 32, "reduced": True,
        "device": "cpu", **knobs})
    return dataclasses.replace(scen, workloads=(wl,))


def test_measured_suites_run_on_a_reduced_workload_on_the_cpu():
    out = BenchRunner(env=env_fingerprint("cpu")).run(
        [_reduced("efficiency/measured"), _reduced("roofline/measured")])
    assert out.ok, out.failures
    eff, roof = out.records
    assert eff.name == "efficiency/reduced2/measured"
    assert eff.derived["gflops_s"] > 0 and eff.env["backend"] == "cpu"
    assert eff.knobs["device"] == "cpu"
    d = roof.derived
    assert roof.name == "roofline/reduced2/measured"
    assert {"dom", "compute_s", "memory_s", "collective_s", "AI", "mfu",
            "step_s", "mfu_measured", "useful_flops_ratio"} <= set(d)
    assert d["collective_s"] == 0.0 and d["dom"] in ("compute", "memory")
    assert d["mfu_measured"] is None        # a CPU time measures no card
    assert 0 < d["useful_flops_ratio"] < 1.05
    # remat: B2 in the forward and the recompute, one B3/B4 a layer, K3 at
    # the two norms a layer (twice) and the final norm; no launch on the CPU
    assert d["kernels"] == {
        "flash_attention_lse": {"calls": 4, "launches": None},
        "flash_attention_dq": {"calls": 2, "launches": None},
        "flash_attention_dkv": {"calls": 2, "launches": None},
        "rmsnorm": {"calls": 9, "launches": None}}


def test_kernel_work_problems():
    from repro_torch.bench.suites.roofline import kernel_work_problems

    def k(calls, launches, flops, per_call=10.0):
        return {"calls": calls, "launches": launches, "flops": flops,
                "bytes": 2 * flops, "per_call_flops": per_call,
                "per_call_bytes": 2 * per_call}
    assert kernel_work_problems({"a": k(3, 3, 30.0),
                                 "b": k(2, None, 20.0)}) == []
    assert len(kernel_work_problems({"a": k(3, 4, 30.0)})) == 1
    assert len(kernel_work_problems({"a": k(3, 3, 31.0)})) == 2
    assert kernel_work_problems({"a": k(0, 0, 0.0)}) == ["a: never counted"]


def test_cli_raises_without_a_card_unless_asked_for_the_cpu(tmp_path,
                                                            capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench_main.main(["--only", "allocation/archs", "--no-json"])
    jsonl = tmp_path / "latest.jsonl"
    assert bench_main.main(["--device", "cpu", "--only", "allocation/archs",
                            "--json", str(jsonl)]) == 0
    recs = read_jsonl(jsonl)
    assert len(recs) == 10 and all(r.env["backend"] == "cpu" for r in recs)
    assert capsys.readouterr().out.splitlines()[0] == CSV_HEADER
    assert bench_main.main(["--device", "cpu", "--list"]) == 0
    assert "roofline/measured" in capsys.readouterr().out
    assert bench_main.main(["--device", "cpu", "--only", "nope",
                            "--no-json"]) == 1


def test_with_device_sets_the_knob_on_measured_suites_only():
    eff = bench_main.with_device(REGISTRY["efficiency/measured"], "cpu")
    assert all(w.knobs["device"] == "cpu" for w in eff.workloads)
    assert [w.knobs["num_layers"] for w in eff.workloads] == [1, 2, 4, 8]
    assert all(w.knobs["seq"] == 4096 for w in eff.workloads)
    alloc = bench_main.with_device(REGISTRY["allocation/layers"], "cpu")
    assert alloc is REGISTRY["allocation/layers"]
    assert "device" not in REGISTRY["efficiency/measured"].workloads[0].knobs


def test_env_fingerprint_on_the_cpu():
    env = env_fingerprint("cpu")
    assert env["backend"] == "cpu" and env["torch"] == torch.__version__
    assert "device_name" not in env and "nvidia_smi" not in env
    assert json.loads(json.dumps(env)) == env


def test_timeit_us_on_the_cpu():
    from repro_torch.bench import timeit_us
    calls = []
    ts = timeit_us(lambda: calls.append(1), iters=3, warmup=2)
    assert len(calls) == 5 and len(ts.samples) == 3 and float(ts) >= 0


def test_report_tables():
    from repro_torch.core.report import (bench_summary, bench_table,
                                         fmt_s, roofline_table)
    recs = [BenchRecord(name="g/a", group="g", us_per_call=12.34,
                        paper_ref="Fig. 9", derived={"x": 0.123456, "y": 2}),
            BenchRecord(name="g/b", group="g", status="error",
                        derived={"y": None})]
    assert bench_table(recs).splitlines() == [
        "| name | us/call | x | y |", "|---|---|---|---|",
        "| g/a | 12.3 | 0.1235 | 2 |", "| g/b (!) | - | - | - |"]
    assert bench_summary(recs).startswith("### g — Fig. 9\n\n| name")
    assert (fmt_s(2.5), fmt_s(0.0125), fmt_s(2e-5), fmt_s(None)) == \
        ("2.50s", "12.5ms", "20us", "-")
    table = roofline_table([{
        "arch": "granite-3-8b", "shape": "train", "mesh": "1x1",
        "roofline": {"compute_s": 1.79, "memory_s": 0.24,
                     "collective_s": 0.0, "dominant": "compute",
                     "mfu": 0.737, "useful_flops_ratio": 0.737},
        "measured": {"step_s": 2.58, "mfu_measured": 0.51}}])
    assert table.splitlines()[-1] == ("| granite-3-8b | train | 1x1 | 1.79s "
                                      "| 240.0ms | 0us | compute | 0.737 "
                                      "| 0.510 | 0.74 | 2.58s |")
