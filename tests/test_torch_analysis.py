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
    (hymba); K3 256 threads at d 4096; f32 K1/B2 at granite's S128 and
    S4096 two warp groups of 128 threads (169,152 B: 128 bytes that align
    the tensor copies, the q tile, each group's two stages of (k, v) and
    its ring's 32 bytes); at D64 also the q tile's TF32 lo, one group of
    128 threads (69,792 B) split eight ways over a cluster at whisper's
    cross attention (B4 Sq4 Sk1500)."""
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
        grid_x=2, grid_y=32, grid_z=1, threads=256, smem=169152, cluster=1)
    assert by[("K1/B2", "float32", (1, 4096, 4096, 32, 8, 128, 0))] == dict(
        grid_x=64, grid_y=32, grid_z=1, threads=256, smem=169152, cluster=1)
    assert by[("K1/B2", "float32", (4, 4, 1500, 20, 20, 64, 0))] == dict(
        grid_x=8, grid_y=20, grid_z=4, threads=128, smem=69792, cluster=8)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,launch", [
    # llama4-like S128 (32 tiles of 128 rows < 132 SMs): one consumer
    # warpgroup, 64-row blocks, D128's 64-key tiles in three stages
    (1, 128, 128, 32, 8, 128, dict(grid_x=2, grid_y=32, grid_z=1,
                                   threads=160, smem=115792, cluster=1)),
    # granite's training S4096: two consumer warpgroups
    (1, 4096, 4096, 32, 8, 128, dict(grid_x=32, grid_y=32, grid_z=1,
                                     threads=384, smem=132176, cluster=1)),
    # whisper's encoder (240 tiles): two, D64's 128-key tiles in two stages
    (1, 1500, 1500, 20, 20, 64, dict(grid_x=12, grid_y=20, grid_z=1,
                                     threads=384, smem=83000, cluster=1)),
    # whisper's cross attention, Sq4 against Sk1500: one
    (4, 4, 1500, 20, 20, 64, dict(grid_x=1, grid_y=20, grid_z=4,
                                  threads=160, smem=74808, cluster=1)),
])
def test_the_bf16_forward_plans_are_the_wgmma_launches(B, Sq, Sk, Hq, Hkv,
                                                       D, launch):
    """K1/B2 in bf16 at D64/D128 plan the wgmma kernel (``WgLayout<D,
    NC>``): consumer warpgroups by whether 128-row tiles fill the 132 SMs,
    1024 bytes of alignment, the q tile, the stages' K and V and 1 + 3
    STAGES mbarriers; the same shape in f32 keeps the mma.sync kernel's
    plan (64 rows, 128 threads or two groups of them, times its cluster
    along x)."""
    dims = dict(B=B, Sq=Sq, Sk=Sk, Hq=Hq, Hkv=Hkv, D=D)
    fwd = kernel_lint.plan_flash_attention({**dims, "dtype": "bfloat16"},
                                           {})[0]
    assert fwd.launch() == launch
    assert kernel_lint.check_plan(fwd) == []
    f32 = kernel_lint.plan_flash_attention({**dims, "dtype": "float32"},
                                           {})[0]
    halves = kernel_lint.fwd_halves(B, Sq, Sk, Hq, D, "float32")
    assert (f32.grid[0], f32.threads) == (f32.cluster * -(-Sq // 64),
                                          256 if halves else 128)


# (B, S, Hq, Hkv, D, cluster): f32 B4's split of its GQA group, from 11b's
# S128 microbatches (qwen2.5's 40:8, G 5: B1-B4 split five ways; B8's 640
# split blocks would be 4.8 waves of the 132 SMs, and its 128 unsplit
# blocks already fill them) to granite's S4096 training shape (512 blocks)
# and whisper's S1500 (G 1); the groups of the repo's models (4, 7, 8) and
# an MQA group of 16 (at most 8, the portable cluster size)
F32_SPLITS = [(1, 128, 40, 8, 128, 5), (2, 128, 40, 8, 128, 5),
              (4, 128, 40, 8, 128, 5), (8, 128, 40, 8, 128, 1),
              (16, 128, 40, 8, 128, 1), (32, 128, 40, 8, 128, 1),
              (1, 4096, 32, 8, 128, 1), (1, 1500, 20, 20, 64, 1),
              (1, 128, 32, 8, 128, 4), (1, 128, 56, 8, 128, 7),
              (2, 128, 64, 8, 128, 8), (1, 200, 16, 1, 64, 8)]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,cluster", F32_SPLITS)
def test_the_f32_b4_plan_splits_its_group_where_the_grid_underfills_the_card(
        B, S, Hq, Hkv, D, cluster):
    """f32 B4 launches as clusters of c blocks along grid x (c the largest
    divisor of the group at most 8 whose split grid stays within four
    waves of the SMs) where B x Hkv x key tiles is below the SM count;
    its grid x is c x the key tiles, each rank a share of the group, and
    the plan breaks no launch rule (a cluster divides grid x, at most 8).
    bf16 never splits, and B3 is never a cluster."""
    dims = dict(B=B, Sq=S, Sk=S, Hq=Hq, Hkv=Hkv, D=D)
    _, b3, b4 = kernel_lint.plan_flash_attention({**dims, "dtype": "float32"},
                                                 {})
    tiles = -(-S // 64)
    assert b4.cluster == cluster
    assert b4.grid == (cluster * tiles, Hkv, B)
    assert ("q heads of a group", Hq // Hkv, Hq // Hkv // cluster,
            cluster) in b4.covers
    assert b3.cluster == 1
    assert kernel_lint.check_plan(b4) == [] == kernel_lint.check_plan(b3)
    assert kernel_lint.bwd_cluster(B, S, Hkv, Hq // Hkv, "float32") == cluster
    if cluster > 1:
        assert B * Hkv * tiles < 132 and (Hq // Hkv) % cluster == 0
    _, _, bf = kernel_lint.plan_flash_attention({**dims, "dtype": "bfloat16"},
                                                {})
    assert bf.cluster == 1


# (B, Sq, Sk, Hq, Hkv, D, cluster, halves): f32 K1/B2's split of the key
# range, over a cluster at whisper's cross attention (47 key tiles: B4 Sq4
# Sk1500's 80 blocks and B1 Sq128's 40 split eight ways) and a causal S512
# (16 key tiles, 64 blocks: four ranks of four tiles); over the two warp
# groups of one block at 11b's B1, B2 and B4 S128 (qwen2.5's 40:8: 80-320
# blocks, fewer than four waves of the SMs; four key tiles, too few for a
# cluster), granite's serving S128 (64), whisper's encoder (480 blocks, 47
# key tiles) and the training S4096 (2048 blocks, 128 key tiles); no split
# at 11b's B8 S128 (640 short blocks) or phase 9's 8-token prefills (one
# key tile)
F32_FWD_SPLITS = [(4, 4, 1500, 20, 20, 64, 8, False),
                  (1, 128, 1500, 20, 20, 64, 8, False),
                  (1, 512, 512, 8, 2, 128, 4, False),
                  (1, 128, 128, 40, 8, 128, 1, True),
                  (1, 128, 128, 32, 8, 128, 1, True),
                  (2, 128, 128, 40, 8, 128, 1, True),
                  (4, 128, 128, 40, 8, 128, 1, True),
                  (8, 128, 128, 40, 8, 128, 1, False),
                  (1, 1500, 1500, 20, 20, 64, 1, True),
                  (1, 4096, 4096, 32, 8, 128, 1, True),
                  (1, 8, 8, 32, 8, 128, 1, False),
                  (4, 8, 8, 32, 8, 128, 1, False)]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,cluster,halves", F32_FWD_SPLITS)
def test_the_f32_forward_plan_splits_its_keys_where_the_grid_underfills_the_card(
        B, Sq, Sk, Hq, Hkv, D, cluster, halves):
    """f32 K1/B2 launch as clusters of c blocks along grid x (c the largest
    at most 8 that leaves each rank four or more of the 32-key tiles of
    Sk) where B x Hq x q tiles is below the SM count, grid x c x the q
    tiles; where that leaves c = 1, Sk has two key tiles and the grid is
    under four waves of the SMs or Sk eight key tiles or more, as blocks
    of two warp groups (256 threads, each group a ring of its own); each
    rank a share of a q tile's key tiles, and no launch rule broken. No
    bf16 plan splits (the wgmma kernel at D64/D128, the mma.sync kernel
    elsewhere)."""
    dims = dict(B=B, Sq=Sq, Sk=Sk, Hq=Hq, Hkv=Hkv, D=D)
    fwd = kernel_lint.plan_flash_attention({**dims, "dtype": "float32"},
                                           {})[0]
    tiles, key_tiles = -(-Sq // 64), -(-Sk // 32)
    ranks = 2 if halves else cluster
    assert fwd.cluster == cluster
    assert fwd.grid == (cluster * tiles, Hq, B)
    assert (fwd.threads, fwd.max_threads) == ((256, 256) if halves
                                              else (128, 128))
    assert ("key tiles of a q tile", key_tiles, -(-key_tiles // ranks),
            ranks) in fwd.covers
    assert kernel_lint.check_plan(fwd) == []
    assert kernel_lint.fwd_cluster(B, Sq, Sk, Hq, D, "float32") == cluster
    assert kernel_lint.fwd_halves(B, Sq, Sk, Hq, D, "float32") == halves
    if cluster > 1:
        assert B * Hq * tiles < 132 and 4 * cluster <= key_tiles
    if halves:
        assert key_tiles >= 2
        assert B * Hq * tiles < 4 * 132 or key_tiles >= 8
    for d in (D, 160):
        bf = kernel_lint.plan_flash_attention(
            {**dims, "D": d, "dtype": "bfloat16"}, {})[0]
        rows = 128 if bf.threads == 384 else 64   # two consumer warpgroups
        assert bf.cluster == 1 and bf.grid[0] == -(-Sq // rows)
        assert not kernel_lint.fwd_halves(B, Sq, Sk, Hq, d, "bfloat16")


def test_no_default_plan_breaks_a_launch_rule():
    """Every default plan at the canonical shapes, f32 B4's split at 11b's
    B1 S128 among them, passes the lint: no RK004 (a cluster over 8 or not
    dividing grid x) nor any other finding."""
    splits = [p for p in kernel_lint.all_plans() if p.cluster > 1]
    assert any(p.kernel == "B4" and p.dtype == "float32" for p in splits)
    assert any(p.kernel == "K1/B2" and p.dtype == "float32" for p in splits)
    assert [f for f in kernel_lint.check_all() if f.rule == "RK004"] == []
    assert kernel_lint.check_defaults() == []


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,dq,dkv", [
    # granite's training S4096: B3 two consumer warpgroups (1024 tiles of
    # 128 q rows); B4 at D128 one, 64 keys a block, whatever the grid
    (1, 4096, 4096, 32, 8, 128,
     dict(grid_x=32, grid_y=32, grid_z=1, threads=384, smem=132152),
     dict(grid_x=64, grid_y=8, grid_z=1, threads=160, smem=100408)),
    # whisper's encoder, S1500 D64 non-causal: 240 tiles each, two
    (1, 1500, 1500, 20, 20, 64,
     dict(grid_x=12, grid_y=20, grid_z=1, threads=384, smem=66616),
     dict(grid_x=12, grid_y=20, grid_z=1, threads=384, smem=67640)),
    # phase 11b's B8 S128 microbatch, qwen2.5's GQA 40:8: B3 two (320 tiles)
    (8, 128, 128, 40, 8, 128,
     dict(grid_x=1, grid_y=40, grid_z=8, threads=384, smem=132152),
     dict(grid_x=2, grid_y=8, grid_z=8, threads=160, smem=100408)),
    # ragged S300 (48 tiles of 128 rows < 132 SMs): one each
    (2, 300, 300, 8, 2, 128,
     dict(grid_x=5, grid_y=8, grid_z=2, threads=160, smem=99384),
     dict(grid_x=5, grid_y=2, grid_z=2, threads=160, smem=100408)),
])
def test_the_bf16_backward_plans_are_the_wgmma_launches(B, Sq, Sk, Hq, Hkv,
                                                        D, dq, dkv):
    """B3 and B4 in bf16 at D64/D128 plan their wgmma kernels
    (``DqLayout<D, NC>``, ``DkvLayout<D, NC>``): consumer warpgroups by
    whether 128-row tiles (B3's q rows, B4's key rows of each head) fill
    the 132 SMs, B4 at D128 always one; 1024 bytes of alignment, the
    resident tiles, two stages of 64-row streamed tiles (and B4's lse and
    delta rows), 1 + 3 STAGES mbarriers. The same shapes in f32 keep the
    mma.sync kernels' plans: 64 rows, 256 threads, ``Layout<T, D, NS>``
    (128 bytes that align the tensor copies' destinations, the tiles, B4's
    lo halves of k and v at D128, 32 bytes of the ring's control); B4
    splits its group over a cluster where its grid underfills the card
    (S300's 20 blocks: four ranks)."""
    dims = dict(B=B, Sq=Sq, Sk=Sk, Hq=Hq, Hkv=Hkv, D=D)
    _, b3, b4 = kernel_lint.plan_flash_attention({**dims, "dtype": "bfloat16"},
                                                 {})
    assert b3.launch() == {**dq, "cluster": 1}
    assert b4.launch() == {**dkv, "cluster": 1}
    assert kernel_lint.check_plan(b3) == [] == kernel_lint.check_plan(b4)
    _, f3, f4 = kernel_lint.plan_flash_attention({**dims, "dtype": "float32"},
                                                 {})
    ld = D + 4
    lo = 2 * 64 * ld if D == 128 else 0
    f3_smem = 128 + (2 * 64 * ld + 2 * 2 * 64 * ld + 64 * 72) * 4 + 32
    f4_smem = 128 + (2 * 64 * ld + 2 * 2 * 32 * ld + 2 * 64 * 40 + lo) * 4 + 32
    split = 4 if Sk == 300 else 1
    assert f3.launch() == dict(grid_x=-(-Sq // 64), grid_y=Hq, grid_z=B,
                               threads=256, smem=f3_smem, cluster=1)
    assert f4.launch() == dict(grid_x=split * -(-Sk // 64), grid_y=Hkv,
                               grid_z=B, threads=256, smem=f4_smem,
                               cluster=split)
    if D == 128:
        assert (f3_smem, f4_smem) == (221344, 223392)


def test_static_shared_memory_of_the_backward_wgmma_instances(tmp_path):
    """B3's and B4's wgmma kernels (no type argument in their mangled
    names) count as B3 and B4 in bf16, beside their mma.sync instances."""
    log = tmp_path / "build.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__67799fe8_"
        "22_flash_attention_bwd_cu_51c9e81920attn_dq_kernel_wgmmaILi128ELi2E"
        "EEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16iiiiiif' for "
        "'sm_90a'\n"
        "ptxas info    : Used 168 registers, 16 bytes smem, 400 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__67799fe8_"
        "22_flash_attention_bwd_cu_51c9e81921attn_dkv_kernel_wgmmaILi64ELi1E"
        "EEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiiiiif' for "
        "'sm_90a'\n"
        "ptxas info    : Used 159 registers, 8 bytes smem, 400 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__67799fe8_"
        "22_flash_attention_bwd_cu_51c9e81914attn_dkv_kernelIfLi128EEEvPKT_"
        "S3_S3_S3_PKfS5_PS1_S6_iiiiiif' for 'sm_90a'\n"
        "ptxas info    : Used 255 registers, 4 bytes smem\n")
    assert kernel_lint.static_smem_from_log(log) == {
        ("B3", "bfloat16"): 16, ("B4", "bfloat16"): 8, ("B4", "float32"): 4}


def test_static_shared_memory_of_the_wgmma_instances(tmp_path):
    """The wgmma kernel's mangled name (no type argument) counts as K1/B2
    in bf16."""
    log = tmp_path / "build.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121attn_"
        "fwd_kernel_wgmmaILi128ELi2EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16"
        "Pfiiiiiif' for 'sm_90a'\n"
        "ptxas info    : Used 168 registers, 16 bytes smem, 400 bytes "
        "cmem[0]\n")
    assert kernel_lint.static_smem_from_log(log) == {
        ("K1/B2", "bfloat16"): 16}


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
