"""The checks of ``chip_smoke.py`` that need no card: phase 2's bf16 gate in
units of bf16 rounding, and phase 1's reading of the kernel instances
(K1/B2, B3, B4, B6, K2, K3) from their mangled names, and the profiler's kernel
groups against the kernels the port defines."""
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _outputs(seed=0, n=20000):
    """f32 values over many binades, as a plain version in f32 gives."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp(3 * rng.standard_normal(n))
    return torch.from_numpy(x.astype(np.float32))


def test_ulp_gate_passes_a_correctly_rounded_output(smoke):
    want = _outputs()
    assert smoke._ulp_err(want.to(torch.bfloat16), want) <= 0.5
    # plus an f32 error of a few 1e-7 relative, as a kernel that sums in
    # another order than the plain version
    noisy = want * (1 + 3e-7 * torch.from_numpy(
        np.random.default_rng(1).standard_normal(want.numel())
        .astype(np.float32)))
    assert smoke._ulp_err(noisy.to(torch.bfloat16), want) <= smoke.ULP_TOL


@pytest.mark.parametrize("units", [2, 3])
def test_ulp_gate_catches_an_output_units_off(smoke, units):
    want = _outputs(seed=units)
    out = want.to(torch.bfloat16)
    off = (out.view(torch.int16) + units).view(torch.bfloat16)
    assert smoke._ulp_err(off, want) >= units - 0.5 > smoke.ULP_TOL


def test_ulp_gate_floors_outputs_near_zero(smoke):
    want = torch.tensor([0.0, 1e-9, -3e-7, 1.0])
    out = torch.tensor([2e-6, 0.0, 0.0, 1.0]).to(torch.bfloat16)
    assert smoke._ulp_err(out, want) == pytest.approx(2e-6 / 2 ** -16,
                                                      rel=1e-2)


def test_held_fields_by_dtype(smoke):
    want = _outputs(n=64)
    f32 = smoke._held(want, want, "float32")
    assert f32 == {"max_abs_err": 0.0, "tol": smoke.TOL["float32"]}
    bf = smoke._held(want.to(torch.bfloat16), want, "bfloat16")
    assert bf["max_ulp_err"] <= 0.5 and bf["ulp_tol"] == smoke.ULP_TOL
    assert "tol" not in bf


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_114attn_dq_kernelIfLi128EEEvPKT_S3_S3_S3_PKfS5_PS1_"
     "iiiiiif", "B3 float32 D128"),
    ("_ZN12_GLOBAL__N_115attn_dkv_kernelI13__nv_bfloat16Li160EEEvPKT_",
     "B4 bfloat16 D160"),
    ("_ZN12_GLOBAL__N_115attn_fwd_kernelIfLi128EEEvPKT_S3_S3_PS1_Pfiiiiiif",
     "K1/B2 float32 D128"),
    ("_ZN39_GLOBAL__N__351eb0a2_7_wkv6_cu_efce1d8411wkv6_kernelIffLi4EEEvPKT_"
     "S3_S3_PKT", "B6 float32 ld float32 VS32"),
    ("_ZN39_GLOBAL__N__351eb0a2_7_wkv6_cu_efce1d8411wkv6_kernelI13__nv_bfloat"
     "16S1_Li8EEEvPKT_", "B6 bfloat16 ld bfloat16 VS64"),
    ("_ZN39_GLOBAL__N__351eb0a2_7_wkv6_cu_efce1d8411wkv6_kernelIf13__nv_bfloa"
     "t16Li2EEEvPKT_", "B6 float32 ld bfloat16 VS16"),
    ("_ZN51_GLOBAL__N__2952c828_18_paged_attention_cu_837bee6819paged_decode_"
     "kernelI13__nv_bfloat16Li1EEEvPKT_", "K2 bfloat16 D<=128"),
    ("_ZN51_GLOBAL__N__2952c828_18_paged_attention_cu_837bee6819paged_decode_"
     "kernelIfLi8EEEvPKT_", "K2 float32 D<=1024"),
    ("_ZN43_GLOBAL__N__a6db163e_10_rmsnorm_cu_7175708d14rmsnorm_kernelIfLi4E"
     "EEvNS_4ArgsE", "K3 float32 vec4"),
    ("_ZN43_GLOBAL__N__a6db163e_10_rmsnorm_cu_7175708d14rmsnorm_kernelI13__nv"
     "_bfloat16Li1EEEvNS_4ArgsE", "K3 bfloat16 vec1"),
    ("_ZN43_GLOBAL__N__a6db163e_10_rmsnorm_cu_7175708d14rmsnorm_kernelI13__nv"
     "_bfloat16Li8EEEvNS_4ArgsE", "K3 bfloat16 vec8"),
    ("_ZN12_GLOBAL__N_117layer_norm_kernelIfEEvPKT_", None),
])
def test_attn_instance_names(smoke, mangled, name):
    assert smoke._attn_instance(mangled) == name


def test_profile_groups_name_the_kernels():
    """Every kernel group of ``core/profile.py`` (the device time by kernel
    that phases 3b, 3c, 5 and 6 report) names a kernel that the port
    defines: a renamed kernel would fall into "other" unnoticed."""
    from repro_torch.core.profile import GROUPS
    src = REPO / "src" / "repro_torch"
    code = "".join(p.read_text() for p in sorted((src / "csrc").glob("*.cu")))
    kernels = [frag for frag, group in GROUPS if group[:2] in
               ("K1", "K2", "K3", "B3", "B4", "B6")]
    assert len(kernels) == 6
    for frag in kernels:
        assert re.search(rf"\b{frag}\s*[(<]", code), frag


# ------------------------------------------- one copy of the card's numbers
def _old_bound(flops, nbytes, dtype):
    """Phase 2's bound as the script computed it before its constants and
    per-kernel counts moved into the package."""
    t_ops = flops / {"float32": 67e12, "bfloat16": 989e12}[dtype]
    t_bytes = nbytes / 3.35e12
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_phase2_bounds_unchanged(smoke, dtype):
    """Every bound of phases 2, 2b and 2c from kernels/work.py and the
    H100 of core/roofline.py equals the script's former inline formula."""
    from repro_torch.kernels import work
    dname = str(dtype).split(".")[1]
    isz = torch.finfo(dtype).bits // 8

    def t(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    # K1 at phase 2's shapes: pairs from the mask, as the script counted
    for S, Hq, Hkv, D, W in ((128, 32, 8, 128, 0), (125, 32, 8, 128, 0),
                             (2048, 32, 8, 128, 0), (128, 25, 5, 64, 1024),
                             (1100, 25, 5, 64, 1024)):
        pos = torch.arange(S)
        keep = pos[:, None] >= pos[None, :]
        if W:
            keep &= pos[:, None] - pos[None, :] < W
        old = _old_bound(4 * Hq * D * int(keep.sum()),
                         isz * S * D * (2 * Hq + 2 * Hkv), dname)
        got = smoke.bound(*work.flash_forward(t(1, S, Hq, D), t(1, S, Hkv, D),
                                              causal=True, window=W), dname)
        assert got == old
        assert smoke.bound_3xtf32(4 * Hq * D * int(keep.sum()), 1.0) == \
            3 * 4 * Hq * D * int(keep.sum()) / 495e12 * 1e3
    # K2
    for B, ctx, npag in ((4, 160, 10), (4, 4096, 256), (1, 160, 256),
                         (4, 160, 256)):
        Hq, Hkv, D, ps = 32, 8, 128, 16
        lens = torch.tensor([ctx, ctx - 1, ctx - 5, ctx - 15][:B],
                            dtype=torch.int32)
        ntok, live = int(lens.sum()), int(((lens + ps - 1) // ps).sum())
        old = _old_bound(4 * Hq * D * ntok, isz * (2 * ntok * Hkv * D
                                                   + 2 * B * Hq * D)
                         + 4 * (live + B), dname)
        assert smoke.bound(*work.paged_decode(
            t(B, 1, Hq, D), t(B * npag + 1, ps, Hkv, D), lens, ps),
            dname) == old
    # K3
    for rows, d in ((128, 4096), (512, 4096), (128, 1600), (1100, 1600),
                    (4, 4096), (4, 1600), (4096, 4096)):
        assert smoke.bound(*work.rmsnorm(rows, d, isz), dname) == \
            _old_bound(4 * rows * d, 2 * isz * rows * d + 4 * d, dname)
    # B2, B3, B4 at the training shape and the ragged length
    B, Hq, Hkv, D = 1, 32, 8, 128
    for S in (4096, 4000):
        q, k = t(B, S, Hq, D), t(B, S, Hkv, D)
        pairs = B * Hq * S * (S + 1) // 2
        rows = 4 * B * Hq * S
        qkv = isz * B * S * D * (Hq + 2 * Hkv)
        kw = dict(causal=True, window=0)
        assert work.flash_forward(q, k, lse=True, **kw) == \
            (4 * D * pairs, qkv + isz * B * S * Hq * D + rows)
        assert work.flash_dq(q, k, **kw) == \
            (6 * D * pairs, qkv + 2 * isz * B * S * Hq * D + 2 * rows)
        assert work.flash_dkv(q, k, **kw) == \
            (8 * D * pairs, qkv + isz * B * S * (Hq * D + 2 * Hkv * D)
             + 2 * rows)


def _old_wkv6_bound(q, v, ld, u, dname):
    """B6's bound as phase 2c computed it before its count moved to
    ``kernels/work.py``."""
    import torch.nn.functional as F
    B, T, H, K = q.shape
    V = v.shape[-1]
    c = 64
    nc = -(-T // c)
    p = torch.cumsum(F.pad(ld.float(), (0, 0, 0, 0, 0, nc * c - T))
                     .reshape(B, nc, c, H, K), dim=2)
    safe = (-p.amin(dim=(2, 4)) < 30.0).float()
    n = torch.full((nc, 1), float(c))
    n[-1] = T - (nc - 1) * c
    pairs = n * (n - 1) / 2 if u is not None else n * (n + 1) / 2
    per_chunk = 2 * pairs * V + 4 * n * K * V + (
        2 * n * (K + V) if u is not None else 0)
    flops = float((safe * (per_chunk + 2 * pairs * K + 4 * n * K)).sum()
                  + ((1 - safe) * (per_chunk + 5 * pairs * K)).sum())
    isz = q.element_size()
    ld_elems = 1
    for size, stride in zip(ld.shape, ld.stride()):
        ld_elems *= size if stride else 1
    nbytes = (isz * B * T * H * (2 * K + V) + ld.element_size() * ld_elems
              + (4 * H * K if u is not None else 0)
              + isz * B * T * H * V + 4 * B * H * K * V)
    return (*_old_bound(flops, nbytes, dname), float(safe.mean()))


@pytest.mark.parametrize("mode,T,H,K,decay", [
    ("rwkv6", 128, 40, 64, "mild"), ("rwkv6", 125, 40, 64, "mild"),
    ("ssd", 128, 25, 16, "per_head"), ("ssd", 1100, 25, 16, "per_head"),
    ("rwkv6", 4096, 40, 64, "strong")])
def test_phase2c_bounds_unchanged(smoke, mode, T, H, K, decay):
    import torch.nn.functional as F

    from repro_torch.kernels import work
    g = torch.Generator().manual_seed(T)
    q = torch.empty((1, T, H, K), device="meta")
    v = torch.empty((1, T, H, 64), device="meta")
    if decay == "mild":
        ld = -torch.exp(-6.0 + 0.5 * torch.randn(1, T, H, K, generator=g))
    elif decay == "strong":
        ld = -torch.exp(torch.randn(1, T, H, K, generator=g))
    else:
        ld = (-F.softplus(torch.randn(1, T, H, 1, generator=g))
              ).expand(1, T, H, K)
    u = torch.randn(H, K, generator=g) if mode == "rwkv6" else None
    want = _old_wkv6_bound(q, v, ld, u, "float32")
    assert smoke.bound(*work.wkv6(q, v, ld, u), "float32") == want[:2]
    assert float(work.wkv6_rescaled(ld, T).mean()) == want[2]


# ------------------------------------------------------ phase 8's gates
def _tier1(arch="granite-3-8b", mfu=0.7, mfu_measured=0.5, useful=0.72):
    return {"train_phase": "6", "arch": arch,
            "roofline": {"mfu": mfu, "useful_flops_ratio": useful},
            "measured": {"mfu_measured": mfu_measured}}


def test_tier1_gates(smoke):
    assert smoke._tier1_problems(_tier1()) == []
    assert len(smoke._tier1_problems(_tier1(mfu=1.2))) == 1
    assert len(smoke._tier1_problems(_tier1(mfu_measured=1.06))) == 1
    assert len(smoke._tier1_problems(_tier1(useful=1.1))) == 1
    assert len(smoke._tier1_problems(_tier1(useful=None))) == 1
    # granite's counted work must be more than half model flops' worth ...
    assert len(smoke._tier1_problems(_tier1(useful=0.5))) == 1
    # ... the other models' need not
    assert smoke._tier1_problems(_tier1("hymba-1.5b", useful=0.4)) == []


def _bench_records(**roofline_derived):
    from repro_torch.bench import BenchRecord
    recs = [BenchRecord(name=f"{s}/x", scenario=s)
            for s in smoke_scenarios()[:5]]
    recs += [BenchRecord(name=f"efficiency/layers{L}/measured",
                         scenario="efficiency/measured")
             for L in (1, 2, 4, 8)]
    d = {"mfu": 0.7, "mfu_measured": 0.5, "useful_flops_ratio": 0.72,
         **roofline_derived}
    recs.append(BenchRecord(name="roofline/granite-3-8b/layers8/measured",
                            scenario="roofline/measured",
                            arch="granite-3-8b", derived=d))
    return recs


def smoke_scenarios():
    return ("allocation/layers", "allocation/hidden", "allocation/archs",
            "load_balance/layers", "load_balance/hidden",
            "efficiency/measured", "roofline/measured")


def test_bench_gates(smoke):
    assert smoke.BENCH_SCENARIOS == smoke_scenarios()
    assert smoke._bench_problems(_bench_records(), []) == []
    assert smoke._bench_problems(_bench_records(), [("x/w", "boom")]) == \
        ["x/w: boom"]
    assert len(smoke._bench_problems(_bench_records(mfu=1.1), [])) == 1
    assert len(smoke._bench_problems(
        _bench_records(useful_flops_ratio=0.4), [])) == 1
    recs = [r for r in _bench_records()
            if r.name != "efficiency/layers4/measured"]
    assert smoke._bench_problems(recs, []) == [
        "efficiency/layers4/measured: no record"]
    recs = [r for r in _bench_records() if r.scenario != "allocation/archs"]
    assert smoke._bench_problems(recs, []) == ["allocation/archs: no record"]


def test_tier1_report_of_a_reduced_step_on_the_cpu(smoke):
    """Phase 6's Tier-1 report path on the CPU: a reduced rwkv6-3b step,
    counted, then the report and its gates."""
    from repro_torch.core.cost import count_cost
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.steps import build_train_step
    rcfg = smoke._train_config("6d-rwkv6", "kernel")
    step, model, opt = build_train_step(rcfg, total_steps=3, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    state = opt.init(params)
    data = SyntheticLM(rcfg.model, smoke.TRAIN_BATCH, rcfg.shape.seq_len,
                       device="cpu")
    cost = count_cost(step, params, state, data.batch_at(0))[1]
    rep = smoke._tier1_report("6d-rwkv6", rcfg, [{"step_s": 0.5}],
                              {"device_busy_share": 0.0}, cost)
    assert rep["arch"] == rcfg.model.name and rep["mesh"] == "1x1"
    assert rep["shape"] == "train" and set(rep["sections"]) == \
        {"O0", "O1", "O3"}
    assert rep["roofline"]["dtype"] == "float32"
    assert rep["roofline"]["model_flops"] == \
        6 * rcfg.model.param_count() * smoke.TRAIN_BATCH * rcfg.shape.seq_len
    assert rep["measured"]["step_s"] == 0.5
    assert rep["counted"]["kernels"] == {}      # layernorm, chunked form
    assert smoke._tier1_problems(rep) == []
    json.dumps(rep)


# ------------------------------------------------------------ phase 9
def _launches(smoke):
    """A full run's launch counts, every kernel launched on every path."""
    paths = ["continuous", "paged", "train:6", "train:6b", "bench",
             "hymba-1.5b:static", "hymba-1.5b:continuous"] + [
        f"{a}:{e}" for a in smoke.SSM_ARCHS for e in ("static",
                                                        "continuous")] + [
        f"serving:{s}" for s in smoke.SERVING_SCENARIOS]
    return {p: dict.fromkeys(smoke.KERNELS, 1) for p in paths}


def test_phase9_is_wired(smoke):
    import inspect

    import repro_torch.bench.suites  # noqa: F401
    from repro_torch.bench import select
    assert list(smoke.SERVING_SCENARIOS) == [
        s.name for s in select(only="serving")]
    assert smoke._missing(_launches(smoke)) == []
    bad = _launches(smoke)
    bad["serving:serving/chaos_soak"]["paged_attention"] = 0
    bad["serving:serving/slot_balance"]["flash_attention"] = 0
    assert smoke._missing(bad) == [
        "paged_attention in serving/chaos_soak",
        "flash_attention in serving/slot_balance"]
    # a kernel a scenario need not launch is not required of it
    fine = _launches(smoke)
    fine["serving:serving/chaos_soak"]["flash_attention"] = 0
    assert smoke._missing(fine) == []
    src = inspect.getsource(smoke.main)
    assert src.index("_bench(dev, tier1)") < src.index(
        "_serve_suite(dev)") < src.index('line = {"kernels"')
    assert src.index("_missing(launches)") > src.index("_serve_suite(dev)")
    last = src.rstrip().splitlines()[-4:]
    assert last[0].strip() == 'print(json.dumps({"ok": True, "device": {'
    assert '"platform": "gpu", "kind": torch.cuda.get_device_name(0),' in \
        last[1]
    assert '"count": torch.cuda.device_count()}}), flush=True)' in last[2]
    assert last[-1].strip() == "return 0"


@pytest.fixture(scope="module")
def phase9_on_the_cpu(smoke):
    """Phase 9 on the reference's reduced cell on the CPU: the suite, the
    copy-on-write run and the gates (which raise on failure). Also the
    shapes the engines gave K1 ((batch, prompt, causal, window) -> calls)
    and K2 ((lanes, page size, table width, pool pages) -> longest
    length, most all-null rows): the same on the reduced cell as at full
    width, since only the heads and widths are cut."""
    torch.set_num_threads(2)
    from repro_torch.bench.suites import serving
    from repro_torch.kernels import ops
    k1, k2 = {}, {}
    flash, paged = ops.flash_attention, ops.paged_attention

    def flash_seen(q, k, v, *, causal, window):
        key = (q.shape[0], q.shape[1], causal, window)
        k1[key] = k1.get(key, 0) + 1
        return flash(q, k, v, causal=causal, window=window)

    def paged_seen(q, kp, vp, bt, lens):
        key = (q.shape[0], kp.shape[1], bt.shape[1], kp.shape[0])
        old = k2.get(key, (0, 0))
        k2[key] = (max(old[0], int(lens.max())),
                   max(old[1], int((bt == 0).all(1).sum())))
        return paged(q, kp, vp, bt, lens)

    ops.flash_attention, ops.paged_attention = flash_seen, paged_seen
    try:
        launches = smoke._serve_suite(torch.device("cpu"), use_reduced=True)
    finally:
        ops.flash_attention, ops.paged_attention = flash, paged
    return launches, dict(serving.REPORTS), {"K1": k1, "K2": k2}


def test_phase9_runs_on_the_cpu(smoke, phase9_on_the_cpu):
    launches, reports, _ = phase9_on_the_cpu
    assert sorted(launches) == sorted(f"serving:{s}"
                                      for s in smoke.SERVING_SCENARIOS)
    # the CPU runs the kernels' plain versions: no launch
    assert all(n == 0 for c in launches.values() for n in c.values())
    assert len(reports) == 21


@pytest.mark.parametrize("break_it,problem", [
    ("tokens", "greedy tokens differ between pd_interleaved and "
               "pd_disaggregated"),
    ("leak", "chaos_on: 3 pages leaked"),
    ("faults", "faults injected/recovered 5/4 of 5"),
    ("concurrency", "peak_concurrency not higher with the prefix cache"),
    ("stall", "decode-step p95 stall not lower disaggregated"),
    ("handoff", "handoffs for"),
])
def test_phase9_gates_trip(smoke, phase9_on_the_cpu, break_it, problem):
    import copy
    _, reports, _ = phase9_on_the_cpu
    reports = copy.deepcopy(reports)
    watch = smoke.SharedPageWatch()
    watch.checks = 1
    cow = {"tokens": {False: {}, True: {}}, "cached": {8: 23},
           "prompt_len": 24}
    assert smoke._serving_problems(reports, [], cow, watch) == []
    if break_it == "tokens":
        m = reports["serving/pd_disaggregated"].metrics[0]
        m.tokens = m.tokens.copy()
        m.tokens[-1] ^= 1
    elif break_it == "leak":
        reports["serving/chaos_on"].pages_leaked = 3
    elif break_it == "faults":
        reports["serving/chaos_on"].fault_recoveries = 4
    elif break_it == "concurrency":
        reports["serving/prefix_burst_on"].peak_concurrency = 3
    elif break_it == "stall":
        reports["serving/pd_disaggregated"].decode_stalls_s = [40.0] * 20
    else:
        reports["serving/pd_disaggregated"].handoffs = 7
    got = smoke._serving_problems(reports, [], cow, watch)
    assert len(got) == 1 and problem in got[0]
    assert any(p.startswith("rid 8 took no") for p in smoke._serving_problems(
        reports, [], {**cow, "cached": {8: 16}}, watch))
    none = smoke.SharedPageWatch()
    assert any("shared pages" in p for p in smoke._serving_problems(
        reports, [], cow, none))


def test_phase2_holds_every_shape_phase9_gives(smoke, phase9_on_the_cpu):
    """Phase 2 holds K1 and K2 against their plain versions at every shape
    phase 9's engines launch them at: each (batch, prompt) of K1, and each
    (lanes, page size, table width, pool) of K2 with a line at least as
    long and with all-null rows where the engines left some."""
    _, _, seen = phase9_on_the_cpu
    assert {(b, s) for b, s, causal, window in seen["K1"]} == \
        set(smoke.SERVING_K1)
    assert all(causal and window == 0 for _, _, causal, window in seen["K1"])
    lines = {}
    for line in smoke.SERVING_K2:
        lines.setdefault(line[:4], []).append(line[4:])
    assert set(seen["K2"]) == set(lines)
    for key, (longest, null_rows) in seen["K2"].items():
        assert max(max(lens) for lens, _, _ in lines[key]) >= longest, key
        assert null_rows == 0 or any(1 in lens or retired
                                     for lens, _, retired in lines[key]), key


@pytest.mark.parametrize("line", range(8))
def test_serving_tables(smoke, line):
    """Each of phase 2's tables at phase 9's shapes is one the engine could
    hold: live rows cover their lengths with distinct pages of the pool
    (the shared leading ones excepted) and the null page past them;
    never-admitted and retired rows are all null."""
    assert len(smoke.SERVING_K2) == 8
    B, ps, npag, P, lens, shared, retired = smoke.SERVING_K2[line]
    assert max(lens) <= npag * ps and len(lens) == B
    draws = []

    def draw(shape):
        draws.append(shape)
        return torch.zeros(shape)

    q, kp, vp, bt, lens_t = smoke._serving_tables(
        draw, torch.Generator().manual_seed(5), B, ps, npag, P, lens,
        shared, retired, "cpu")
    assert draws == [(B, 1, 32, 128), (P, ps, 8, 128), (P, ps, 8, 128)]
    assert bt.dtype == torch.int32 and tuple(bt.shape) == (B, npag)
    assert lens_t.tolist() == list(lens)
    owned = []
    for b, n in enumerate(lens):
        row = bt[b].tolist()
        if n == 1 or b in retired:
            assert row == [0] * npag
            continue
        live = -(-n // ps)
        assert all(0 < p < P for p in row[:live]) and \
            row[live:] == [0] * (npag - live)
        assert row[:shared] == bt[0, :shared].tolist()
        owned += row[shared:live]
    assert len(owned) == len(set(owned))
    assert not set(owned) & set(bt[0, :shared].tolist())
