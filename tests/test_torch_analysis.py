"""The port's static analysis (``repro_torch.analysis``) on the CPU, held
to the JAX package's ``repro.analysis`` where the two compute the same
thing: the seam lint over the reference's fixtures, pragmas and
``Finding`` records, the rule catalog and the CLI's contract; then the
port's own layers: the launch-contract lint of the CUDA kernels against
the H100's limits, and the dispatch audit of the real step functions,
each clean on the tree and tripped by a planted violation.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from repro.analysis import __main__ as jax_cli
from repro.analysis import seams as jax_seams
from repro.analysis.findings import RULES as JAX_RULES
from repro.analysis.findings import Finding as JaxFinding
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import graph_audit, kernel_lint, seams
from repro_torch.analysis.findings import RULES, Finding
from repro_torch.kernels import tuning

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "analysis"
SEAM_FIXTURES = {"bad_assert.py": "RS101", "bad_free.py": "RS102",
                 "bad_admission.py": "RS103", "bad_wallclock.py": "RS104"}


# ------------------------------------------------------------- seam lint
def test_the_ports_tree_is_clean():
    findings = seams.scan_tree()
    assert findings == [], [str(f) for f in findings]


@pytest.mark.parametrize("fixture,rule", sorted(SEAM_FIXTURES.items()))
def test_seam_lint_gives_the_references_findings(fixture, rule):
    """RS101-RS104 on the reference's fixtures: the same (rule, line)
    and the same JSON records."""
    got = seams.scan_file(FIXTURES / fixture)
    want = jax_seams.scan_file(FIXTURES / fixture)
    assert [(f.rule, f.line) for f in got] == \
        [(f.rule, f.line) for f in want]
    assert rule in {f.rule for f in got}
    assert [f.to_json() for f in got] == [f.to_json() for f in want]


def test_rs105_follows_torch_not_jax():
    """The reference's RS105 fixture passes a function to ``jax.jit``,
    which the port's lint does not look for."""
    assert seams.scan_file(FIXTURES / "bad_numpy_in_jit.py") == []


COMPILED = {
    "torch_compile_call": (
        "import numpy as np\nimport torch\n"
        "def step(x):\n    return np.asarray(x)\n"
        "fast = torch.compile(step)\n", 4),
    "torch_compile_decorator": (
        "import numpy as np\nimport torch\n"
        "@torch.compile\ndef step(x):\n    return np.add(x, 1)\n", 5),
    "torch_compile_decorator_call": (
        "import numpy as np\nimport torch\n"
        "@torch.compile(mode='reduce-overhead')\n"
        "def step(x):\n    return numpy.zeros(3)\n", 5),
    "partial_of_compile": (
        "import functools\nimport numpy as np\nimport torch\n"
        "@functools.partial(torch.compile, dynamic=False)\n"
        "def step(x):\n    return np.ones(2)\n", 6),
    "jit_script": (
        "import numpy as np\nimport torch\n"
        "def step(x):\n    y = x\n    return np.sum(y)\n"
        "scripted = torch.jit.script(step)\n", 5),
    "graphed_callables": (
        "import numpy as np\nimport torch\n"
        "def f(x):\n    return x\n"
        "def g(x):\n    return np.asarray(x)\n"
        "fg = torch.cuda.make_graphed_callables((f, g), ((1,), (1,)))\n", 6),
}


@pytest.mark.parametrize("name", sorted(COMPILED))
def test_rs105_trips_on_a_compiled_function(tmp_path, name):
    src, line = COMPILED[name]
    path = tmp_path / f"{name}.py"
    path.write_text(src)
    findings = seams.scan_file(path)
    assert [(f.rule, f.line) for f in findings] == [("RS105", line)]


def test_numpy_outside_a_compiled_function_is_not_flagged():
    src = ("import numpy as np\nimport torch\n"
           "def host_side(x):\n    return np.asarray(x)\n"
           "def device_side(x):\n    return x * 2\n"
           "f = torch.compile(device_side)\n")
    assert seams.scan_source(src, "mod.py") == []


PRAGMAS = {
    "same_line": "def f(x):\n    assert x  # repro: allow=RS101\n",
    "line_above_wildcard": "def f(x):\n    # repro: allow=*\n    assert x\n",
    "other_rule": "def f(x):\n    assert x  # repro: allow=RS102\n",
    "free_outside_seam": "class R:\n    def go(self, a):\n"
                         "        a.free(1)  # repro: allow=RS102\n"
                         "        a.free(2)\n",
    "release_pages_seam": "class PagedEngine:\n"
                          "    def _release_pages(self, alloc, rid):\n"
                          "        alloc.free(rid)\n",
    "scheduler_validate": "class RoleEngine:\n    def run(self, requests):\n"
                          "        sched = Scheduler(self)\n"
                          "        reqs, rejected = sched.validate(requests)\n"
                          "        return reqs\n",
    "clock_class": "import time\nfrom repro_torch.serving.request import "
                   "SimClock\nclass WallClock:\n    def now(self):\n"
                   "        return time.perf_counter()\n"
                   "def leak():\n    return time.time()\n",
}


@pytest.mark.parametrize("name", sorted(PRAGMAS))
def test_pragmas_and_seams_as_the_reference(name):
    """The same findings (as JSON records) as the reference's lint on the
    same source; the port's serving scope also covers its own package."""
    src = PRAGMAS[name]
    path = "serving/mod.py" if name == "clock_class" else "mod.py"
    got = [f.to_json() for f in seams.scan_source(src, path)]
    want = [f.to_json() for f in jax_seams.scan_source(src, path)]
    assert got == want
    if name == "clock_class":
        assert [json.loads(g)["line"] for g in got] == [7]


def test_a_module_importing_the_ports_serving_layer_is_serving_scoped():
    src = ("import time\nfrom repro_torch.serving.request import Request\n"
           "def f():\n    return time.monotonic()\n")
    assert [(f.rule, f.line) for f in seams.scan_source(src, "x.py")] == \
        [("RS104", 4)]


def test_finding_records_are_the_references():
    for rule in ("RS101", "RS102", "RS103", "RS104"):
        f, jf = (cls(rule, "src/x.py", 42, "boom")
                 for cls in (Finding, JaxFinding))
        assert f.to_json() == jf.to_json() and str(f) == str(jf)
    assert str(Finding("RK001", "a.cu", 0, "m")).startswith("a.cu:0: RK001")


def test_the_rule_ids_are_the_references():
    assert sorted(RULES) == sorted(JAX_RULES)
    assert all(RULES[r] for r in RULES)
    assert {r: RULES[r] for r in RULES if r.startswith("RS")
            and r != "RS105"} == {r: JAX_RULES[r] for r in JAX_RULES
                                  if r.startswith("RS") and r != "RS105"}


# ------------------------------------------------------------ kernel lint
def test_the_defaults_are_legal_at_the_canonical_shapes():
    findings = kernel_lint.check_defaults(static_smem={})
    assert findings == [], [str(f) for f in findings]


def test_static_shared_memory_is_read_from_the_ptxas_report(tmp_path):
    log = tmp_path / "build.log"
    log.write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_114rmsnorm_kernelIfLi4EEEvNS_4ArgsE' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers, 64 bytes smem, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118paged_decode_kernelI13__nv_bfloat16Li1EEEvPKT_'"
        " for 'sm_90a'\n"
        "ptxas info    : Used 80 registers, 400 bytes cmem[0]\n")
    static = kernel_lint.static_smem_from_log(log)
    assert static == {("K3", "float32"): 64}
    plan = kernel_lint.plans("rmsnorm_fwd", dict(rows=4, d=64),
                             {"threads": 32}, static)[0]
    assert plan.static_smem == 64
    assert kernel_lint.static_smem_from_log(tmp_path / "none.log") == {}


PLANTED = {
    "splits16": ("paged_attention_fwd",
                 dict(B=4, Hq=32, Hkv=8, D=128, P=41, ps=16, npag=10),
                 {"splits": 16}, "RK004"),
    "splits16_short_table": ("paged_attention_fwd",
                             dict(B=4, Hq=32, Hkv=8, D=128, P=9, ps=16,
                                  npag=2), {"splits": 16}, "RK004"),
    "k2_d_not_vec": ("paged_attention_fwd",
                     dict(B=4, Hq=32, Hkv=8, D=126, P=41, ps=16, npag=10),
                     {"splits": 4}, "RK003"),
    "v_slice128": ("wkv6_fwd", dict(B=1, T=128, H=40, K=64, V=64),
                   {"v_slice": 128}, "RK003"),
    "v_slice128_smem": ("wkv6_fwd", dict(B=1, T=128, H=40, K=64, V=64),
                        {"v_slice": 128}, "RK002"),
    "v_slice64_k64_f32": ("wkv6_fwd", dict(B=1, T=128, H=40, K=64, V=64),
                          {"v_slice": 64}, "RK002"),
    "k128": ("wkv6_fwd", dict(B=1, T=128, H=40, K=128, V=64),
             {"v_slice": 32}, "RK003"),
    "heads_past_grid_y": ("wkv6_fwd", dict(B=1, T=128, H=70000, K=16, V=16),
                          {"v_slice": 16}, "RK004"),
    "threads2048": ("rmsnorm_fwd", dict(rows=128, d=4096),
                    {"threads": 2048}, "RK004"),
    "threads_not_warps": ("rmsnorm_fwd", dict(rows=128, d=4096),
                          {"threads": 100}, "RK004"),
    "rmsnorm_f64": ("rmsnorm_fwd", dict(rows=128, d=4096, dtype="float64"),
                    {"threads": 256}, "RK005"),
    "d96": ("flash_attention", dict(B=1, Sq=128, Sk=128, Hq=32, Hkv=8,
                                    D=96), {}, "RK003"),
    "batch_past_grid_z": ("flash_attention", dict(B=70000, Sq=64, Sk=64,
                                                  Hq=4, Hkv=4, D=64), {},
                          "RK004"),
}


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_each_illegal_plan_is_rejected(name):
    kernel, dims, config, rule = PLANTED[name]
    findings = kernel_lint.check_config(kernel, dims, config, static_smem={})
    assert rule in {f.rule for f in findings}, [str(f) for f in findings]


def test_coverage_and_clusters_are_checked():
    plan = kernel_lint.Plan(kernel="X", path="x.cu", dtype="float32",
                            grid=(6, 1, 1), threads=128, smem=0, cluster=4,
                            covers=[("rows", 1000, 128, 7)])
    rules = [f.rule for f in kernel_lint.check_plan(plan)]
    assert sorted(rules) == ["RK001", "RK004"]   # 7 x 128 < 1000; 6 % 4
    plan.covers, plan.grid = [("rows", 1000, 128, 8)], (8, 1, 1)
    assert kernel_lint.check_plan(plan) == []
    plan.smem = 232448
    plan.static_smem = 1
    assert [f.rule for f in kernel_lint.check_plan(plan)] == ["RK002"]


def test_default_plans_are_the_c_launchers():
    """The lint's plans at the canonical shapes, by the mirrored layouts
    (the card holds each to the C plan query, phase 14a): K2 4 splits of
    100,408 B in f32; B6 V slices of 32 (rwkv6, 215,440 B) and 16
    (hymba); K3 256 threads at d 4096; K1/B2 101,376 B in f32."""
    by = {(p.kernel, p.dtype, p.query_args): p.launch()
          for p in kernel_lint.all_plans()}
    assert by[("K2", "float32", (4, 41, 16, 32, 8, 128, 10, 0, 4))] == dict(
        grid_x=4, grid_y=8, grid_z=4, threads=256, smem=100408, cluster=4)
    assert by[("B6", "float32", (1, 128, 40, 64, 64, 0, 0, 32))] == dict(
        grid_x=2, grid_y=40, grid_z=1, threads=256, smem=215440, cluster=1)
    assert by[("B6", "float32", (1, 128, 25, 16, 64, 0, 0, 16))]["grid_x"] \
        == 4
    assert by[("K3", "float32", (128, 4096, 0, 1, 256))]["threads"] == 256
    assert by[("K1/B2", "float32", (1, 128, 128, 32, 8, 128, 0))] == dict(
        grid_x=2, grid_y=32, grid_z=1, threads=128, smem=101376, cluster=1)


@pytest.fixture
def tuned_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(tuning.ENV_VAR, str(tmp_path))
    tuning.clear_cache()
    yield tmp_path
    tuning.clear_cache()


def _write_cache(path: Path, entries: dict) -> None:
    (path / "cuda.json").write_text(json.dumps(
        {"version": 1, "env": {}, "entries": entries}))


def test_tuned_cache_entries_are_checked(tuned_dir):
    sig = tuning.paged_attention_signature((4, 1, 32, 128), (41, 16, 8, 128),
                                           10, "float32")
    key = tuning.entry_key("paged_attention_fwd", sig)
    _write_cache(tuned_dir, {key: {"config": {"splits": 2}}})
    assert kernel_lint.check_tuned_cache(static_smem={}) == []
    _write_cache(tuned_dir, {key: {"config": {"splits": 16}}})
    findings = kernel_lint.check_tuned_cache(static_smem={})
    assert {f.rule for f in findings} == {"RK004"}
    assert all(f.path == "results/tuned/cuda.json" for f in findings)
    _write_cache(tuned_dir, {"wkv6_fwd|garbage": {"config": {"v_slice": 16}}})
    assert [f.rule for f in kernel_lint.check_tuned_cache(static_smem={})] \
        == ["RK001"]


def test_signatures_parse_back_into_dims():
    sig = tuning.wkv6_signature((1, 128, 40, 64), 64, torch.bfloat16,
                                use_u=True)
    assert kernel_lint.sig_dims("wkv6_fwd", sig) == dict(
        B=1, T=128, H=40, K=64, V=64, dtype="bfloat16", u=1, ld="float32")
    assert kernel_lint.sig_dims("rmsnorm_fwd", "rows=4") is None


# ------------------------------------------------------------ graph audit
@pytest.mark.parametrize("audit", ["train_step", "decode_step",
                                   "paged_steps", "engine_steady_state"])
def test_the_real_steps_are_clean(audit):
    findings = getattr(graph_audit, f"audit_{audit}")("cpu")
    assert findings == [], [str(f) for f in findings]


def test_the_train_steps_guard_is_its_one_host_read():
    """The train step's loss-spike guard reads one scalar; held to none,
    the audit names it."""
    from repro_torch.runtime.steps import build_train_step
    rcfg = graph_audit._run_config("train", 256)
    step, model, opt = build_train_step(rcfg, total_steps=8, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    state = opt.init(params)
    from repro_torch.data.pipeline import SyntheticLM
    batch = SyntheticLM(rcfg.model, 2, 32, seed=0, device="cpu").batch_at(0)
    findings = graph_audit.audit_function("step", step, params, state, batch,
                                          host_reads=0)
    assert [f.rule for f in findings] == ["RG001"]


def _item_step(x):
    return x * float((x.sum() > 0).item())


def _f64_step(x):
    return x.double().sum().float()


PLANTED_STEPS = {"RG001": _item_step, "RG002": _f64_step}


@pytest.mark.parametrize("rule", sorted(PLANTED_STEPS))
def test_a_planted_step_is_flagged(rule):
    findings = graph_audit.audit_function("planted", PLANTED_STEPS[rule],
                                          torch.ones(4))
    assert findings and {f.rule for f in findings} == {rule}


def test_a_collective_in_a_one_rank_step_is_flagged(tmp_path):
    import torch.distributed as dist
    owned = not dist.is_initialized()
    if owned:
        dist.init_process_group("gloo", store=dist.FileStore(
            str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        assert dist.get_world_size() == 1

        def step(x):
            dist.all_reduce(x)
            return x

        findings = graph_audit.audit_function("planted", step, torch.ones(4))
    finally:
        if owned:
            dist.destroy_process_group()
    assert [f.rule for f in findings] == ["RG004"]


@pytest.mark.parametrize("read", [lambda x: len(x.tolist()),
                                  lambda x: float(x.numpy().sum())],
                         ids=["tolist", "numpy"])
def test_host_reads_that_skip_the_dispatcher_on_the_cpu(read):
    """``.tolist()`` and ``.numpy()`` of a CPU tensor reach no aten
    operation, so RG001 cannot see them on the CPU; on the card each is a
    device-to-host copy, which RG005 flags
    (``tests/test_torch_cuda.py::test_a_transfer_inside_a_step_is_flagged_on_the_card``)."""
    assert graph_audit.audit_function("read", lambda x: x * read(x),
                                      torch.ones(4)) == []


def test_copies_on_the_cpu_are_not_transfers():
    """RG005 fires only on the card: on the CPU a ``.cpu()`` or ``.to``
    stays on one device (the card test holds a real transfer)."""
    def step(x):
        return x.cpu().to(torch.float32).clone() + x.to("cpu")

    assert graph_audit.audit_function("copies", step, torch.ones(4)) == []


def test_a_second_run_that_does_more_is_flagged(monkeypatch):
    engine, cfg = graph_audit.tiny_engine("cpu")
    runs = []
    real = engine.run

    def run(reqs):
        runs.append(1)
        if len(runs) == 3:      # the warm-up, then the two runs compared
            torch.zeros(3).add_(1)      # an operation the first run lacks
        return real(reqs)

    engine.run = run
    monkeypatch.setattr(graph_audit, "tiny_engine", lambda device: (engine,
                                                                    cfg))
    findings = graph_audit.audit_engine_steady_state("cpu")
    assert [f.rule for f in findings] == ["RG003"]
    assert "dispatched operations" in findings[0].message


# -------------------------------------------------------------------- CLI
def test_cli_clean_tree_exits_zero(capsys):
    assert cli.main(["--layer", "seams", "--layer", "kernels"]) == 0
    assert "clean" in capsys.readouterr().err


def test_cli_all_layers_exit_zero(capsys):
    assert cli.main(["--no-steady-state"]) == 0
    assert "[seams,kernels,graphs]: clean" in capsys.readouterr().err


def test_cli_planted_seam_violations_exit_one(capsys):
    assert cli.main(["--layer", "seams", "--root", str(FIXTURES)]) == 1
    out = capsys.readouterr().out
    for rule in SEAM_FIXTURES.values():
        assert rule in out


def test_cli_a_planted_cache_entry_exits_one(tuned_dir, capsys):
    sig = tuning.rmsnorm_signature(128, 4096, "float32")
    _write_cache(tuned_dir, {tuning.entry_key("rmsnorm_fwd", sig):
                             {"config": {"threads": 2048}}})
    assert cli.main(["--layer", "kernels", "--json"]) == 1
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["rule"] for r in recs] == ["RK004"]


def test_cli_json_output_is_jsonl(capsys):
    assert cli.main(["--layer", "seams", "--root", str(FIXTURES),
                     "--json"]) == 1
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    recs = [json.loads(ln) for ln in lines]
    assert all({"rule", "path", "line", "message", "name"} <= set(r)
               for r in recs)
    assert {r["rule"] for r in recs} == set(SEAM_FIXTURES.values())


def test_cli_list_rules_is_the_references(capsys):
    assert cli.main(["--list-rules"]) == 0
    ours = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert jax_cli.main(["--list-rules"]) == 0
    theirs = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert ours == theirs


def test_cli_internal_error_exits_two(monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(kernel_lint, "check_all", boom)
    assert cli.main(["--layer", "kernels"]) == 2
    assert "analysis error: RuntimeError: planted" in capsys.readouterr().err


def test_cli_has_no_backend_flag():
    with pytest.raises(SystemExit):
        cli.main(["--backend", "tpu"])
