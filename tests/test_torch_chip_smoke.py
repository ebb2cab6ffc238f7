"""The checks of ``chip_smoke.py`` that need no card: phase 2's bf16 gate in
units of bf16 rounding, and phase 1's reading of the kernel instances
(K1/B2, B3, B4, B6, K2, K3) from their mangled names, and the profiler's kernel
groups against the kernels the port defines."""
import importlib.util
import json
import math
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
    ("_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_51c9e81915attn_dkv_"
     "kernelIfLi128ELb0EEEvNS_4MapsEPKfS3_PT_S5_iiiiiif", "B4 float32 D128"),
    ("_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_51c9e81915attn_dkv_"
     "kernelIfLi128ELb1EEEvNS_4MapsEPKfS3_PT_S5_iiiiiif",
     "B4 float32 D128 cluster"),
    ("_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_51c9e81915attn_dkv_"
     "kernelI13__nv_bfloat16Li32ELb0EEEvNS_4MapsEPKfS4_PT_S6_iiiiiif",
     "B4 bfloat16 D32"),
    ("_ZN12_GLOBAL__N_115attn_fwd_kernelIfLi128EEEvPKT_S3_S3_PS1_Pfiiiiiif",
     "K1/B2 float32 D128"),
    ("_ZN55_GLOBAL__N__4bd8c1a2_17_flash_attention_cu_2e11f0b815attn_fwd_"
     "kernelIfLi128ELb0ELb0EEEvN4attn4MapsEPT_Pfiiiiiif", "K1/B2 float32 D128"),
    ("_ZN55_GLOBAL__N__4bd8c1a2_17_flash_attention_cu_2e11f0b815attn_fwd_"
     "kernelIfLi64ELb1ELb0EEEvN4attn4MapsEPT_Pfiiiiiif",
     "K1/B2 float32 D64 cluster"),
    ("_ZN55_GLOBAL__N__4bd8c1a2_17_flash_attention_cu_2e11f0b815attn_fwd_"
     "kernelIfLi128ELb0ELb1EEEvN4attn4MapsEPT_Pfiiiiiif",
     "K1/B2 float32 D128 halves"),
    ("_ZN55_GLOBAL__N__4bd8c1a2_17_flash_attention_cu_2e11f0b815attn_fwd_"
     "kernelI13__nv_bfloat16Li160ELb0ELb0EEEvN4attn4MapsEPT_Pfiiiiiif",
     "K1/B2 bfloat16 D160"),
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
    ("_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_a939580c21attn_fwd_"
     "kernel_wgmmaILi128ELi2EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16"
     "Pfiiiiiif", "K1/B2 bfloat16 D128 BQ128"),
    ("_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_a939580c21attn_fwd_"
     "kernel_wgmmaILi64ELi1EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16"
     "Pfiiiiiif", "K1/B2 bfloat16 D64 BQ64"),
    ("_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_51c9e81920attn_dq_"
     "kernel_wgmmaILi128ELi2EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_"
     "bfloat16iiiiiif", "B3 bfloat16 D128 BQ128"),
    ("_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_51c9e81920attn_dq_"
     "kernel_wgmmaILi64ELi1EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_"
     "bfloat16iiiiiif", "B3 bfloat16 D64 BQ64"),
    ("_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_51c9e81921attn_dkv_"
     "kernel_wgmmaILi64ELi1EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_"
     "bfloat16S5_iiiiiif", "B4 bfloat16 D64 BK64"),
    ("_ZN55_GLOBAL__N__67799fe8_22_flash_attention_bwd_cu_51c9e81921attn_dkv_"
     "kernel_wgmmaILi128ELi1EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_"
     "bfloat16S5_iiiiiif", "B4 bfloat16 D128 BK64"),
])
def test_attn_instance_names(smoke, mangled, name):
    assert smoke._attn_instance(mangled) == name


def _sass(body: dict) -> str:
    """A ``cuobjdump -sass`` listing of the bf16 forward's four wgmma
    instances, each function's body the lines ``body`` gives its name."""
    out = ["\tcode for sm_90a"]
    for d, nc in ((64, 1), (64, 2), (128, 1), (128, 2)):
        out.append(f"\t\tFunction : _ZN12_GLOBAL__N_121attn_fwd_kernel_"
                   f"wgmmaILi{d}ELi{nc}EEEv14CUtensorMap_stS1_S1_P13__nv_"
                   f"bfloat16Pfiiiiiif")
        out.append('\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"')
        for i, line in enumerate(body[f"D{d} BQ{64 * nc}"]):
            out.append(f"        /*{16 * i:04x}*/                   {line} ;")
    return "\n".join(out) + "\n"


WGMMA_BODY = ["LDC R1, c[0x0][0x28]", "UTMALDG.4D [UR8], [UR4]",
              "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R3",
              "HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT",
              "HGMMA.64x64x16.F32.BF16 R24, R152, gdesc[UR8], R24, gsb0",
              "EXIT"]


@pytest.mark.parametrize("change,problem", [
    (None, None),
    ("no_hgmma", "no HGMMA or no TMA load"),
    ("no_tma", "no HGMMA or no TMA load"),
    ("hmma", "HMMA or cp.async left"),
    ("cp_async", "HMMA or cp.async left"),
    ("spills", "spills"),
])
def test_phase1_holds_the_wgmma_instances(smoke, change, problem):
    """Phase 1's check of the bf16 forward's wgmma instances, on SASS
    listings: HGMMA and UTMALDG (TMA loads) in each, no HMMA, no LDGSTS
    (cp.async) and no spills pass; a listing without HGMMA or TMA loads, or
    with HMMA or cp.async left in one instance, or spilling, fails and
    names that instance."""
    body = {n: list(WGMMA_BODY) for n in ("D64 BQ64", "D64 BQ128",
                                          "D128 BQ64", "D128 BQ128")}
    edit = {"no_hgmma": lambda b: [x for x in b if "HGMMA" not in x],
            "no_tma": lambda b: [x for x in b if "UTMALDG" not in x],
            "hmma": lambda b: b + ["HMMA.16816.F32.BF16 R4, R8, R12, R4"],
            "cp_async": lambda b: b + ["LDGSTS.E.BYPASS.LTC128B.128 [R3], "
                                       "desc[UR6][R4.64]"]}
    if change in edit:
        body["D128 BQ128"] = edit[change](body["D128 BQ128"])
    report = smoke._count_sass(_sass(body))
    assert sorted(report) == ["K1/B2 bfloat16 D128 BQ128",
                              "K1/B2 bfloat16 D128 BQ64",
                              "K1/B2 bfloat16 D64 BQ128",
                              "K1/B2 bfloat16 D64 BQ64"]
    for name, counts in report.items():
        counts["spill_bytes"] = 0
    if change == "spills":
        report["K1/B2 bfloat16 D128 BQ128"]["spill_bytes"] = 8
    if change is None:
        assert report["K1/B2 bfloat16 D64 BQ64"] == {
            "hmma": 0, "hgmma": 2, "utmaldg": 1, "ldgsts": 0, "spill_bytes": 0}
    found = smoke._wgmma_problems(report)
    if problem is None:
        assert found == []
    else:
        assert found == [f"K1/B2 bfloat16 D128 BQ128: {problem}"]


def test_phase1_wants_every_wgmma_head_dim(smoke):
    """A build without the D64 instances (or any wgmma instance) fails."""
    report = {"K1/B2 bfloat16 D128 BQ128": {"hmma": 0, "hgmma": 24,
                                            "utmaldg": 6, "ldgsts": 0,
                                            "spill_bytes": 0}}
    assert smoke._wgmma_problems(report) == [
        "no K1/B2 bfloat16 D64 instance"]
    assert len(smoke._wgmma_problems({})) == 2


# the backward's wgmma instances, (kernel, head dim, consumer warpgroups):
# B3 at both sizes of both head dims, B4 at D64 (both) and D128 (one)
BWD_INSTANCES = (("dq", 64, 1), ("dq", 64, 2), ("dq", 128, 1), ("dq", 128, 2),
                 ("dkv", 64, 1), ("dkv", 64, 2), ("dkv", 128, 1))


def _bwd_name(kernel: str, d: int, nc: int) -> str:
    return (f"{'B3' if kernel == 'dq' else 'B4'} bfloat16 D{d} "
            f"{'BQ' if kernel == 'dq' else 'BK'}{64 * nc}")


def _bwd_sass(body: dict, instances=BWD_INSTANCES) -> str:
    """A ``cuobjdump -sass`` listing of the backward's wgmma instances, each
    function's body the lines ``body`` gives its name."""
    out = ["\tcode for sm_90a"]
    for kernel, d, nc in instances:
        n = 20 if kernel == "dq" else 21
        out.append(f"\t\tFunction : _ZN55_GLOBAL__N__67799fe8_22_flash_"
                   f"attention_bwd_cu_51c9e819{n}attn_{kernel}_kernel_wgmmaILi"
                   f"{d}ELi{nc}EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_"
                   f"bfloat16iiiiiif")
        out.append('\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"')
        for i, line in enumerate(body[_bwd_name(kernel, d, nc)]):
            out.append(f"        /*{16 * i:04x}*/                   {line} ;")
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("target", ["B3 bfloat16 D128 BQ128",
                                    "B4 bfloat16 D128 BK64",
                                    "B4 bfloat16 D64 BK128"])
@pytest.mark.parametrize("change,problem", [
    (None, None),
    ("no_hgmma", "no HGMMA or no TMA load"),
    ("no_tma", "no HGMMA or no TMA load"),
    ("hmma", "HMMA or cp.async left"),
    ("cp_async", "HMMA or cp.async left"),
    ("spills", "spills"),
])
def test_phase1_holds_the_backward_wgmma_instances(smoke, target, change,
                                                   problem):
    """Phase 1's check of B3's and B4's bf16 wgmma instances, on SASS
    listings: HGMMA and UTMALDG in each, no HMMA, no LDGSTS and no spills
    pass; a listing without HGMMA or TMA loads, or with HMMA or cp.async
    left in one instance, or spilling, fails and names that instance, under
    its own kernel's check only."""
    names = [_bwd_name(*i) for i in BWD_INSTANCES]
    body = {n: list(WGMMA_BODY) for n in names}
    edit = {"no_hgmma": lambda b: [x for x in b if "HGMMA" not in x],
            "no_tma": lambda b: [x for x in b if "UTMALDG" not in x],
            "hmma": lambda b: b + ["HMMA.16816.F32.BF16 R4, R8, R12, R4"],
            "cp_async": lambda b: b + ["LDGSTS.E.BYPASS.LTC128B.128 [R3], "
                                       "desc[UR6][R4.64]"]}
    if change in edit:
        body[target] = edit[change](body[target])
    report = smoke._count_sass(_bwd_sass(body))
    assert sorted(report) == sorted(names)
    for counts in report.values():
        counts["spill_bytes"] = 0
    if change == "spills":
        report[target]["spill_bytes"] = 8
    found = {k: smoke._wgmma_problems(report, k) for k in ("B3", "B4")}
    kernel = target.split()[0]
    assert found[kernel] == ([] if problem is None
                             else [f"{target}: {problem}"])
    assert found["B4" if kernel == "B3" else "B3"] == []
    # the forward's check, over the same report, misses only its instances
    assert smoke._wgmma_problems(report) == [
        "no K1/B2 bfloat16 D64 instance", "no K1/B2 bfloat16 D128 instance"]


def test_phase1_wants_the_backward_wgmma_at_every_head_dim(smoke):
    """A build without the D64 backward instances fails phase 1's check of
    B3 and of B4, naming the head dim."""
    d128 = [i for i in BWD_INSTANCES if i[1] == 128]
    body = {_bwd_name(*i): list(WGMMA_BODY) for i in d128}
    report = smoke._count_sass(_bwd_sass(body, d128))
    for counts in report.values():
        counts["spill_bytes"] = 0
    assert sorted(report) == ["B3 bfloat16 D128 BQ128",
                              "B3 bfloat16 D128 BQ64",
                              "B4 bfloat16 D128 BK64"]
    assert smoke._wgmma_problems(report, "B3") == [
        "no B3 bfloat16 D64 instance"]
    assert smoke._wgmma_problems(report, "B4") == [
        "no B4 bfloat16 D64 instance"]
    assert smoke.WGMMA_KERNELS == ("K1/B2", "B3", "B4")


# the f32 forward's mma.sync instances as phase 1 counts them: HMMA and TMA
# loads, no cp.async, no spills
F32_FWD_OK = {"hmma": 300, "hgmma": 0, "utmaldg": 3, "ldgsts": 0,
              "spill_bytes": 0}


@pytest.mark.parametrize("change,problem", [
    (None, None),
    ("no_hmma", "no HMMA or no TMA load"),
    ("no_tma", "no HMMA or no TMA load"),
    ("cp_async", "cp.async left"),
    ("spills", "spills"),
])
@pytest.mark.parametrize("target", ["K1/B2 float32 D128",
                                    "K1/B2 float32 D128 cluster",
                                    "K1/B2 float32 D128 halves",
                                    "K1/B2 float32 D16"])
def test_phase1_holds_the_f32_forward_instances(smoke, target, change,
                                                problem):
    """Phase 1's check of the f32 forward (K1/B2 on mma.sync, fed by TMA):
    every f32 instance, at every head dim, unsplit and split (a cluster's
    rank, two warp groups), has HMMA and UTMALDG, no LDGSTS and no spills;
    one that lacks HMMA or TMA loads, keeps a cp.async or spills fails and
    is named. The three D128 instances are in F32_D128 (HMMA, no
    spills)."""
    names = ["K1/B2 float32 D16", "K1/B2 float32 D64",
             "K1/B2 float32 D64 cluster", "K1/B2 float32 D64 halves",
             "K1/B2 float32 D128", "K1/B2 float32 D128 cluster",
             "K1/B2 float32 D128 halves"]
    report = {n: dict(F32_FWD_OK) for n in names}
    report["K1/B2 bfloat16 D160"] = {**F32_FWD_OK, "utmaldg": 0}
    edit = {"no_hmma": {"hmma": 0}, "no_tma": {"utmaldg": 0},
            "cp_async": {"ldgsts": 4}, "spills": {"spill_bytes": 8}}
    report[target].update(edit.get(change, {}))
    found = smoke._f32_fwd_problems(report)
    assert found == ([] if problem is None else [f"{target}: {problem}"])
    assert set(smoke.F32_FWD_D128) == {"K1/B2 float32 D128",
                                       "K1/B2 float32 D128 cluster",
                                       "K1/B2 float32 D128 halves"}
    assert set(smoke.F32_FWD_D128) < set(smoke.F32_D128)


def test_phase1_wants_the_f32_forward_cluster_instance(smoke):
    """A build without the f32 forward's split instances at D128 (or with
    no f32 forward at all) fails phase 1's check."""
    report = {"K1/B2 float32 D128": dict(F32_FWD_OK)}
    assert smoke._f32_fwd_problems(report) == [
        "no K1/B2 float32 D128 cluster instance",
        "no K1/B2 float32 D128 halves instance"]
    assert len(smoke._f32_fwd_problems({})) == 3


def test_k1_b2_lines_carry_their_cluster(smoke, monkeypatch):
    """Phase 2's K1 lines (its own, phase 10's and phase 11's shapes) and
    phase 2b's B2 lines carry their launch's cluster from the C plan query
    of the forward, as B3's and B4's lines carry theirs: the dtype goes to
    the query as its code (0 f32, 1 bf16)."""
    import inspect

    from repro_torch.kernels import _build
    asked = []

    def plan(name, *args):
        asked.append((name, args))
        return {"cluster": 4}

    monkeypatch.setattr(_build, "plan", plan)
    assert smoke._fwd_cluster(1, 4, 1500, 20, 20, 64, "float32") == 4
    assert smoke._fwd_cluster(1, 128, 128, 40, 8, 128, "bfloat16") == 4
    assert asked == [("flash_attention_fwd", (1, 4, 1500, 20, 20, 64, 0)),
                     ("flash_attention_fwd", (1, 128, 128, 40, 8, 128, 1))]
    main = inspect.getsource(smoke.main)
    assert '"cluster": _fwd_cluster(B, S, S, Hq, Hkv, D, dname)' in main
    family = inspect.getsource(smoke._family_kernels)
    assert '"cluster": _fwd_cluster(B, Sq, Sk, Hq, Hkv, D, dname)' in family
    train = inspect.getsource(smoke._train_kernels)
    assert '"flash_attention_fwd" if name == "flash_attention_lse"' in train


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
            for s in smoke_scenarios()[:6]]
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
            "load_balance/layers", "load_balance/hidden", "load_balance/moe",
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
    paths = ["continuous", "paged", "train:6", "train:6b", "train:6e",
             "bench", "hymba-1.5b:static", "hymba-1.5b:continuous"] + [
        f"{a}:{e}" for a in smoke.SSM_ARCHS for e in ("static",
                                                        "continuous")] + [
        f"serving:{s}" for s in smoke.SERVING_SCENARIOS] + list(
        smoke.FAMILY_PATHS) + list(smoke.BF16_PATHS) + list(
        smoke.PHASE12_PATHS) + list(smoke.PHASE13_PATHS)
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


# ----------------------------------------------------------- phase 10
def test_phase10_is_wired(smoke):
    """Phase 10 runs after the training phases and before phase 8 (whose
    Tier-1 lines include 10a's), and the kernels line fails when one of
    its paths launched none of a kernel it must."""
    import inspect
    src = inspect.getsource(smoke.main)
    assert src.index('"6d-hymba"') < src.index("_families(dev)") < \
        src.index("_bench(dev, tier1)")
    bad = _launches(smoke)
    bad["arctic-480b:paged"]["paged_attention"] = 0
    bad["whisper:serve"]["flash_attention"] = 0
    assert smoke._missing(bad) == [
        "flash_attention in whisper:serve",
        "paged_attention in arctic-480b:paged"]
    assert "load_balance/moe" in smoke.BENCH_SCENARIOS
    assert smoke.TRAIN["10a"]["arch"] == "whisper-large-v3"


def test_layernorm_paths_want_no_rmsnorm(smoke):
    """stablelm-12b's LayerNorm: its served paths (f32 10e, bf16 11e) need
    K1 or K2 but not K3, and the launch check fails when K3 launched on
    any of its runs; an RMSNorm model's engines need K3 on the card."""
    from repro_torch.configs import get_arch
    ln, rms = get_arch(smoke.STABLELM), get_arch(smoke.QWEN15)
    assert ln.norm == "layernorm" and rms.norm == "rmsnorm"
    assert smoke._norm_launches(ln) == ((), ("rmsnorm",))
    assert smoke._norm_launches(rms) == (("rmsnorm",), ())
    stablelm = {p: k for p, k in {**smoke.FAMILY_PATHS,
                                  **smoke.BF16_PATHS}.items()
                if p.startswith(smoke.STABLELM + ":")}
    assert stablelm == {
        f"{smoke.STABLELM}:continuous": ("flash_attention",),
        f"{smoke.STABLELM}:paged": ("paged_attention",),
        f"{smoke.STABLELM}:continuous:bf16": ("flash_attention",),
        f"{smoke.STABLELM}:paged:bf16": ("paged_attention",)}

    def runs(arch, **over):
        out = {f"{arch}:{e}": dict.fromkeys(smoke.KERNELS, 0)
               for e in ("continuous", "paged", "plain")}
        out[f"{arch}:continuous"]["flash_attention"] = 7
        out[f"{arch}:paged"]["paged_attention"] = 5
        for path, n in over.items():
            out[f"{arch}:{path}"]["rmsnorm"] = n
        return out

    a = smoke.STABLELM
    for on_card in (True, False):
        assert smoke._engine_launch_problems(a, ln, runs(a), on_card) == []
    assert smoke._engine_launch_problems(
        a, ln, runs(a, paged=3, plain=1), False) == [
        f"{a}:paged launched rmsnorm 3 times on a layernorm model",
        f"{a}:plain launched rmsnorm 1 times on a layernorm model"]
    q = smoke.QWEN15
    assert smoke._engine_launch_problems(q, rms, runs(q), True) == [
        "continuous launched no rmsnorm", "paged launched no rmsnorm"]
    assert smoke._engine_launch_problems(q, rms, runs(q), False) == []
    assert smoke._engine_launch_problems(
        q, rms, runs(q, continuous=4, paged=4), True) == []
    bad = _launches(smoke)
    bad["train:6e"]["flash_attention_dkv"] = 0
    assert smoke._missing(bad) == ["flash_attention_dkv"]


def test_step_launch_problems(smoke):
    """6e's steps: B2-B4 every step and B3/B4 once per layer and
    microbatch, no K1, no B6, and K3 only where the norm is RMSNorm."""
    import dataclasses

    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch(smoke.STABLELM), num_layers=4)
    step = {k: 0 for k in smoke.KERNELS}
    step.update(flash_attention_lse=16, flash_attention_dq=8,
                flash_attention_dkv=8)
    assert smoke._step_launch_problems([step, step], cfg, 2) == []
    assert smoke._step_launch_problems(
        [step, {**step, "rmsnorm": 5, "flash_attention": 1}], cfg, 2) == [
        "step 1 launched flash_attention 1 times",
        "step 1 launched rmsnorm 5 times"]
    assert smoke._step_launch_problems([step], cfg, 1) == [
        "step 0 launched flash_attention_dq 8 times, not 4",
        "step 0 launched flash_attention_dkv 8 times, not 4"]
    rms = dataclasses.replace(cfg, norm="rmsnorm")
    assert smoke._step_launch_problems([step], rms, 2) == [
        "step 0 launched no rmsnorm"]
    assert smoke._step_launch_problems([{**step, "rmsnorm": 9}], rms,
                                       2) == []
    spec = smoke.TRAIN["6e"]
    assert (spec["arch"], spec["layers"], spec["gate"]) == (
        smoke.STABLELM, 4, "free")
    rcfg = smoke._train_config("6e", "kernel")
    assert rcfg.model.d_model == 5120 and rcfg.model.num_layers == 4
    assert rcfg.param_dtype == "float32" and rcfg.remat

def test_attention_calls_per_forward(smoke):
    from repro_torch.configs import get_arch
    assert smoke._attention_calls(get_arch("granite-3-8b")) == 40
    assert smoke._attention_calls(get_arch("whisper-large-v3")) == 96


def test_one_ulp_q_moves_the_plain_attention_and_restores_it(smoke):
    from repro_torch.models import attention as attn_mod
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 6, 2, 16), generator=gen) for _ in "qkv")
    before = attn_mod.dense_attention(q, k, v, causal=True)
    orig = attn_mod.dense_attention
    with smoke._one_ulp_q(True):
        moved = attn_mod.dense_attention(q, k, v, causal=True)
    assert attn_mod.dense_attention is orig
    with smoke._one_ulp_q(False):
        assert attn_mod.dense_attention is orig
    diff = float((moved - before).abs().max())
    assert 0 < diff < 1e-5


def test_f32_attention_rounds_the_plain_attention_once_and_restores_it(
        smoke):
    """11e's third path: the plain attention computed in f32 from bf16 q,
    k, v and rounded once, against the plain path's own bf16 roundings."""
    from repro_torch.models import attention as attn_mod
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 40, 4, 32), generator=gen).to(torch.bfloat16)
               for _ in "qkv")
    orig = attn_mod.dense_attention
    plain = orig(q, k, v, causal=True)
    with smoke._f32_attention(True):
        exact = attn_mod.dense_attention(q, k, v, causal=True)
    assert attn_mod.dense_attention is orig
    with smoke._f32_attention(False):
        assert attn_mod.dense_attention is orig
    want = orig(q.float(), k.float(), v.float(), causal=True)
    assert exact.dtype == torch.bfloat16
    assert torch.equal(exact, want.to(torch.bfloat16))
    assert not torch.equal(plain, exact)


def test_planted_faults_move_the_kernels_attention_only(smoke):
    """11e's controls: ("ulps", k) moves each nonzero element of the
    kernels' attention output k units of its own bf16 rounding, both ways;
    ("p_bf16", 0) is attention in f32 with P rounded once; the plain
    backend is untouched and the module restored."""
    from repro_torch.kernels.ref import dense_attention
    from repro_torch.models import attention as attn_mod
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 40, 4, 32), generator=gen).to(torch.bfloat16)
    k, v = (torch.randn((1, 40, 2, 32), generator=gen).to(torch.bfloat16)
            for _ in "kv")
    orig, cpu = attn_mod.attention, torch.device("cpu")
    good = orig(q, k, v, backend="kernel", causal=True)
    plain = orig(q, k, v, backend="dense", causal=True)
    _, e = torch.frexp(good.float())
    step = torch.ldexp(torch.ones_like(good.float()), e - 8)
    for n in (1, 4):
        with smoke._planted_fault(("ulps", n), cpu):
            bad = attn_mod.attention(q, k, v, backend="kernel", causal=True)
            assert torch.equal(attn_mod.attention(
                q, k, v, backend="dense", causal=True), plain)
        assert attn_mod.attention is orig
        moved = ((bad.float() - good.float()) / step)[good != 0]
        assert bad.dtype == torch.bfloat16
        assert (moved > 0).any() and (moved < 0).any()
        if n == 1:      # one unit up or down is always representable
            assert torch.equal(moved.abs(), torch.ones_like(moved))
        else:           # n units up may cross into a coarser binade
            assert float((moved.abs() - n).abs().max()) <= 1
    with smoke._planted_fault(("p_bf16", 0), cpu):
        got = attn_mod.attention(q, k, v, backend="kernel", causal=True,
                                 window=7)
    assert attn_mod.attention is orig
    exact = dense_attention(q.float(), k.float(), v.float(), causal=True,
                            window=7)
    assert got.dtype == torch.bfloat16 and not torch.equal(
        got, exact.to(torch.bfloat16))
    assert torch.allclose(got.float(), exact, atol=2e-2)
    # in f32, rounding P to q's dtype rounds nothing: the plain attention
    f32 = smoke._p_bf16_attention(q.float(), k.float(), v.float(),
                                  causal=True, window=7)
    assert torch.allclose(f32, exact, atol=1e-6, rtol=0)
    with smoke._planted_fault(None, cpu):
        assert attn_mod.attention is orig
    assert set(smoke.REJECTED_FAULTS) <= set(smoke.PLANTED_FAULTS)


def test_sdpa_backend_is_the_dispatchers_choice(smoke):
    """Phase 2's K1 lines name SDPA's backend as its dispatcher picks it,
    without running a profile (whose hooks would stay on the host)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 16, 32), generator=gen)
    k, v = (torch.randn((1, 2, 16, 32), generator=gen) for _ in "kv")
    got = smoke._sdpa_backend(q, k, v, True)
    assert got in SDPBackend.__members__ and got != "ERROR"
    with sdpa_kernel(SDPBackend.MATH):
        assert smoke._sdpa_backend(q, k, v, False) == "MATH"


def test_host_turns_reads_the_floor_and_phase3():
    """``host_turns.py`` reads the floor call and phase 3's two engines
    (not another arch's serve lines) from a run's output."""
    spec = importlib.util.spec_from_file_location(
        "host_turns", REPO / "host_turns.py")
    host_turns = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(host_turns)
    serve = {"phase": "serve", "ttft_p50_s": 0.5, "tok_p50_s": 0.05}
    out = "\n".join([
        "NVIDIA H100 80GB HBM3, 700.00 W",
        json.dumps({"phase": "floor", "ms": 0.001, "call_ms": 0.008}),
        json.dumps({**serve, "scheduler": "continuous"}),
        json.dumps({**serve, "scheduler": "paged", "tok_p50_s": 0.04}),
        json.dumps({**serve, "scheduler": "paged", "arch": "rwkv6-3b",
                    "tok_p50_s": 9.0})])
    assert host_turns._readings(out) == {
        "floor_call_us": 8.0, "continuous_ttft_p50_s": 0.5,
        "continuous_tok_p50_s": 0.05, "paged_ttft_p50_s": 0.5,
        "paged_tok_p50_s": 0.04}
    assert set(host_turns._readings(out)) == set(host_turns.READINGS)


@pytest.fixture(scope="module")
def phase10_on_the_cpu(smoke):
    """Phase 10's serving on the reference's reduced configs on the CPU:
    whisper through ``serve_loop.generate``, qwen2-vl, arctic, stablelm
    and qwen1.5 through the three engines (their gates raise on failure);
    and the shapes they
    gave K1 ((batch, Sq, Sk, causal, window) -> calls) and K2 ((lanes,
    page size, table width, pool pages) -> calls): the same on the
    reduced configs as at full width, since only the heads, widths and
    depth are cut."""
    torch.set_num_threads(2)
    from repro_torch.kernels import ops
    k1, k2 = {}, {}
    flash, paged = ops.flash_attention, ops.paged_attention

    def flash_seen(q, k, v, *, causal, window):
        key = (q.shape[0], q.shape[1], k.shape[1], causal, window)
        k1[key] = k1.get(key, 0) + 1
        return flash(q, k, v, causal=causal, window=window)

    def paged_seen(q, kp, vp, bt, lens):
        key = (q.shape[0], kp.shape[1], bt.shape[1], kp.shape[0])
        k2[key] = k2.get(key, 0) + 1
        return paged(q, kp, vp, bt, lens)

    cpu = torch.device("cpu")
    ops.flash_attention, ops.paged_attention = flash_seen, paged_seen
    try:
        launches = smoke._serve_whisper(cpu, use_reduced=True)
        for arch in smoke.FAMILY_LAYERS:
            launches.update(smoke._serve_family(cpu, arch, use_reduced=True))
    finally:
        ops.flash_attention, ops.paged_attention = flash, paged
    return launches, {"K1": k1, "K2": k2}


def test_phase10_runs_on_the_cpu(smoke, phase10_on_the_cpu):
    launches, seen = phase10_on_the_cpu
    assert set(smoke.FAMILY_PATHS) - {"train:10a"} <= set(launches)
    # the CPU runs the kernels' plain versions: no launch
    assert all(n == 0 for c in launches.values() for n in c.values())
    # whisper's prefills (the warm-up's, the served run's, the parity
    # check's): encoder (non-causal), decoder prompt (causal) and cross
    # attention (non-causal, Sq != Sk), once a layer (2 reduced) each
    w = smoke.WHISPER
    B, S, F = w["requests"], w["prompt"], w["frames"]
    assert {key: n for key, n in seen["K1"].items() if key[0] == B} == {
        (B, F, F, False, 0): 6, (B, S, S, True, 0): 6, (B, S, F, False, 0): 6}


def test_phase2_holds_every_shape_phase10_gives(smoke, phase10_on_the_cpu):
    """Phase 2 holds K1 and K2 against their plain versions at every shape
    phase 10 launches them at: each (batch, Sq, Sk, mask) of K1, with the
    full configs' heads (stablelm-12b's in STABLELM_K1; qwen1.5-110b's are
    qwen2-vl's), and K2 at phase 3's paged table with qwen2-vl's, arctic's
    and stablelm's heads."""
    from repro_torch.configs import get_arch
    _, seen = phase10_on_the_cpu
    k1 = smoke.FAMILY_K1 + smoke.STABLELM_K1
    lines = {(b, sq, sk, causal) for b, sq, sk, _, _, _, causal in k1}
    assert {(b, sq, sk, causal) for b, sq, sk, causal, window in seen["K1"]
            if window == 0} <= lines
    assert {(b, sq, sk, causal) for b, sq, sk, _, _, _, causal
            in smoke.STABLELM_K1} == {(1, 128, 128, True), (1, 125, 125, True)}

    def heads(a):
        c = get_arch(a)
        return (c.num_heads, c.num_kv_heads, c.resolved_head_dim)

    archs = ("whisper-large-v3", "qwen2-vl-72b", "arctic-480b",
             smoke.STABLELM, smoke.QWEN15)
    assert {a[3:6] for a in k1} == {heads(a) for a in archs}
    assert {a[3:6] for a in smoke.STABLELM_K1} == {heads(smoke.STABLELM)}
    assert heads(smoke.QWEN15) == heads("qwen2-vl-72b")
    assert set(seen["K2"]) == {(4, 16, 10, 41)}
    assert set(smoke.FAMILY_K2 + smoke.STABLELM_K2) == {
        heads(a) for a in archs[1:]}
    assert smoke.STABLELM_K2 == (heads(smoke.STABLELM),)
    # phase 2b at whisper's training microbatch, both masks
    cfg, seq = get_arch("whisper-large-v3"), smoke.TRAIN["10a"]["seq"]
    rows = smoke.TRAIN_BATCH // 2
    assert {a for a in smoke.TRAIN_ATTN if a[4] == 64} == {
        (rows, seq, cfg.num_heads, cfg.num_kv_heads, 64, causal)
        for causal in (False, True)}


# ----------------------------------------------------------- phase 11
def test_phase11_is_wired(smoke):
    """Phases 11a-11d run after phase 10 and before phase 8 (whose Tier-1
    lines include 11a's), and the kernels line fails when one of their
    paths launched none of a kernel it must."""
    import inspect
    src = inspect.getsource(smoke.main)
    assert src.index("_families(dev)") < src.index("_bf16_phases(dev)") < \
        src.index("_bench(dev, tier1)")
    bad = _launches(smoke)
    bad["deploy"]["flash_attention_dkv"] = 0
    bad[f"{smoke.LLAMA4}:paged"]["paged_attention"] = 0
    assert smoke._missing(bad) == [
        "flash_attention_dkv in deploy",
        f"paged_attention in {smoke.LLAMA4}:paged"]
    spec = smoke.TRAIN["11a"]
    assert (spec["arch"], spec["layers"], spec["dtype"]) == (
        "granite-3-8b", 8, "bfloat16")
    assert smoke._train_tol("11a", smoke.GRAD_TOL) == 2e-2
    assert smoke._train_tol("6", smoke.GRAD_TOL) == smoke.GRAD_TOL
    rcfg = smoke._train_config("11a", "kernel")
    assert rcfg.param_dtype == "bfloat16" and rcfg.opt_master
    assert smoke._train_config("6", "kernel").param_dtype == "float32"


@pytest.mark.parametrize("dtype,per", [("float32", 20), ("bfloat16", 18)])
def test_memory_reckoning_by_dtype(smoke, dtype, per):
    import dataclasses
    rcfg = dataclasses.replace(smoke._train_config("6", "kernel"),
                               param_dtype=dtype)
    got = smoke._memory_reckoning(1000, rcfg)
    assert got["state_bytes_per_param"] == per
    assert got["microbatch_grad_bytes"] == (2 if per == 18 else 4) * 1000


def test_one_ulp_q_in_bf16(smoke):
    """In bf16 the plain attention's q moves by one bf16 unit, away from
    zero."""
    from repro_torch.models import attention as attn_mod
    q = torch.tensor([1.0, -1.0, 0.15625, -3.0]).to(torch.bfloat16)
    seen = []
    orig = attn_mod.dense_attention
    attn_mod.dense_attention = lambda q, k, v, **kw: seen.append(q)
    try:
        with smoke._one_ulp_q(True):
            attn_mod.dense_attention(q, None, None)
    finally:
        attn_mod.dense_attention = orig
    moved = seen[0].float()
    assert moved.tolist() == [1.0078125, -1.0078125, 0.1572265625,
                              -3.015625]


def test_bf16_unit(smoke):
    assert smoke._bf16_unit(torch.tensor([0.5, -7.9])) == 2.0 ** -5
    assert smoke._bf16_unit(torch.tensor([1.0])) == 2.0 ** -7


def _margins(table):
    return lambda rid, step: {"margin": table[(rid, step)], "paths": {}}


@pytest.mark.parametrize("b,table,flips,problems", [
    ({0: [1, 2, 3], 1: [4, 5]}, {}, [], 0),
    # rid 1 flips at step 1 within the bound; later steps are not compared
    ({0: [1, 2, 3], 1: [4, 9, 7]}, {(1, 1): 0.01}, [(1, 1, True)], 0),
    # a flip whose margin exceeds the bound fails
    ({0: [1, 2, 8], 1: [4, 5]}, {(0, 2): 0.5}, [(0, 2, False)], 1),
    # a missing rid or a shorter run fails
    ({0: [1, 2, 3]}, {}, [], 1),
    ({0: [1, 2], 1: [4, 5]}, {}, [], 1),
])
def test_flip_rule(smoke, b, table, flips, problems):
    a = {0: [1, 2, 3], 1: [4, 5]}
    if table.get((1, 1)):
        a = {0: [1, 2, 3], 1: [4, 5, 6]}
    got, bad = smoke._flip_check(a, b, _margins(table), 0.03125)
    assert [(f["rid"], f["step"], f["ok"]) for f in got] == flips
    assert len(bad) == problems
    assert all(f["bound"] == 0.03125 and f["paths"] == {} for f in got)


def test_flip_rule_with_no_bound_wants_identical_tokens(smoke):
    """10b and 10c hold their tokens identical: a bound of -inf fails
    every flip, whatever its margin."""
    a = {0: [1, 2, 3], 1: [4, 5]}
    got, bad = smoke._flip_check(a, {0: [1, 2, 3], 1: [4, 6]},
                                 _margins({(1, 1): 0.0}), -math.inf)
    assert [(f["rid"], f["step"], f["ok"]) for f in got] == [(1, 1, False)]
    assert len(bad) == 1
    assert smoke._flip_check(a, dict(a), _margins({}), -math.inf) == ([], [])


def test_min_router_margin_tracks_a_near_tie(smoke):
    """A token whose two best experts' router probabilities differ by
    about 1.5e-4 sets the smallest margin; the MoE FFN is restored after."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import moe as moe_mod
    cfg = reduced(get_arch("llama4-maverick-400b-a17b"), d_model=8,
                  d_ff=16, experts=4)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_aux_weight=0.0))
    p = moe_mod.moe_init(torch.Generator().manual_seed(0), cfg,
                         torch.float32)
    p["router"] = torch.zeros((8, 4))
    p["router"][0, 0] = p["router"][1, 1] = 1.0
    p["router"][2, 2] = p["router"][3, 3] = 1.0
    x = torch.zeros((1, 3, 8))
    x[0, 0, :4] = torch.tensor([2.0, 0.0, 0.0, 0.0])       # clear winner
    x[0, 1, :4] = torch.tensor([1.0, 1.0004, 0.0, 0.0])    # a near-tie
    x[0, 2, :4] = torch.tensor([0.0, 0.0, 3.0, 1.0])
    orig = moe_mod.moe_ffn
    with smoke._expert_load() as rm:
        y, aux = moe_mod.moe_ffn(p, x, cfg)
    assert moe_mod.moe_ffn is orig
    probs = torch.softmax(x[0, 1, :4], -1)
    assert rm.smallest == pytest.approx(float(probs[1] - probs[0]),
                                        rel=1e-4)
    assert 0 < rm.smallest < 2e-4
    assert [c["experts"].tolist() for c in rm.calls] == [[[0], [1], [2]]]
    assert rm.last_token()["experts"] == [2]
    assert torch.equal(rm.total, aux["expert_load"])
    assert torch.equal(y, orig(p, x, cfg)[0])


def test_token_routes_keep_what_the_capacity_keeps(smoke):
    """Tokens past an expert's capacity, in token order, are not kept,
    as ``moe_ffn`` drops them: its expert load counts the kept pairs."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import moe as moe_mod
    cfg = reduced(get_arch("llama4-maverick-400b-a17b"), d_model=8,
                  d_ff=16, experts=4)
    p = moe_mod.moe_init(torch.Generator().manual_seed(0), cfg,
                         torch.float32)
    p["router"] = torch.zeros((8, 4))
    p["router"][0, 0] = p["router"][1, 1] = 1.0
    x = torch.zeros((1, 16, 8))
    x[0, :12, 0] = 3.0          # 12 tokens to expert 0, capacity 8
    x[0, 12:, 1] = 3.0          # 4 to expert 1
    with smoke._expert_load() as seen:
        _, aux = moe_mod.moe_ffn(p, x, cfg)
    keep = seen.calls[0]["keep"][:, 0]
    assert aux["capacity"] == 8
    assert keep.tolist() == [True] * 8 + [False] * 4 + [True] * 4
    assert seen.total.tolist() == [8.0, 4.0, 0.0, 0.0]


def _call(experts, keep=None):
    e = torch.tensor(experts)[:, None]
    k = torch.ones_like(e, dtype=torch.bool) if keep is None else \
        torch.tensor(keep, dtype=torch.bool)[:, None]
    return {"experts": e, "keep": k}


@pytest.mark.parametrize("a,b,pointwise,want", [
    # one layer: only the rerouted (or dropped) positions
    ([[0, 1, 2, 3]], [[0, 2, 2, 3]], True, [0, 1, 0, 0]),
    ([_call([0, 1, 2, 3], [1, 1, 0, 1])], [_call([0, 1, 2, 3])], True,
     [0, 0, 1, 0]),
    # an earlier layer's reroute reaches every later position
    ([[0, 1, 2, 3], [0, 1, 2, 3]], [[0, 3, 2, 3], [0, 1, 2, 2]], True,
     [0, 1, 1, 1]),
    ([[0, 1, 2, 3], [0, 1, 2, 3]], [[0, 1, 2, 3], [0, 1, 3, 3]], True,
     [0, 0, 1, 0]),
    # not every layer an MoE: attention may follow the last one
    ([[0, 1, 2, 3]], [[0, 2, 2, 3]], False, [0, 1, 1, 1]),
])
def test_rerouted_positions(smoke, a, b, pointwise, want):
    a, b = ([c if isinstance(c, dict) else _call(c) for c in x]
            for x in (a, b))
    assert smoke._rerouted(a, b, pointwise).tolist() == [bool(w)
                                                          for w in want]


def test_deploy_gates(smoke):
    from repro_torch.bench import BenchRecord

    def rec(name, tok=100.0, status="ok"):
        return BenchRecord(name=name, status=status, derived={"tok_s": tok})
    good = [rec(n) for n in smoke.DEPLOY_RECORDS]
    all_in = dict.fromkeys(smoke.KERNELS, 1)
    assert smoke._deploy_problems(good, [], all_in, True) == []
    worse = good[:2] + [rec(good[2].name, float("nan"))] + good[4:]
    out = smoke._deploy_problems(worse, [("deploy/batch", "boom")],
                                 {**all_in, "rmsnorm": 0}, True)
    assert out == ["deploy/batch: boom",
                   "deploy/batch4: no record with a finite tok_s (nan)",
                   "deploy/batch8: no record with a finite tok_s (None)",
                   "deploy launched no rmsnorm"]
    # the CPU launches no kernel: not required there
    assert smoke._deploy_problems(good, [], {}, False) == []


@pytest.fixture(scope="module")
def phase11_on_the_cpu(smoke, tmp_path_factory):
    """Phases 11b-11e on the reference's reduced configs on the CPU (their
    gates raise on failure), and the shapes 11b, 11c and 11e gave the
    kernels' wrappers: K1 (batch, Sq, Sk, causal, window, dtype), B2-B4 (batch,
    Sq, Sk, causal, dtype: the attention differentiated), K2 (lanes, page
    size, table width, pool pages, dtype) and K3 (rows, d, dtype), each
    -> calls; the same on the reduced configs as at full width, since
    only the heads, widths and depth are cut."""
    torch.set_num_threads(2)
    from repro_torch.kernels import ops
    seen = {"K1": {}, "B2-B4": {}, "K2": {}, "K3": {}}
    flash, paged, norm = ops.flash_attention, ops.paged_attention, ops.rmsnorm

    def add(kernel, key):
        seen[kernel][key] = seen[kernel].get(key, 0) + 1

    def flash_seen(q, k, v, *, causal, window):
        dt = str(q.dtype).split(".")[1]
        if q.requires_grad or k.requires_grad or v.requires_grad:
            add("B2-B4", (q.shape[0], q.shape[1], k.shape[1], causal, dt))
        else:
            add("K1", (q.shape[0], q.shape[1], k.shape[1], causal, window,
                       dt))
        return flash(q, k, v, causal=causal, window=window)

    def paged_seen(q, kp, vp, bt, lens):
        add("K2", (q.shape[0], kp.shape[1], bt.shape[1], kp.shape[0],
                   str(q.dtype).split(".")[1]))
        return paged(q, kp, vp, bt, lens)

    def norm_seen(x, scale, **kw):
        add("K3", (x.numel() // x.shape[-1], x.shape[-1],
                   str(x.dtype).split(".")[1]))
        return norm(x, scale, **kw)

    cpu = torch.device("cpu")
    ops.flash_attention, ops.paged_attention, ops.rmsnorm = (
        flash_seen, paged_seen, norm_seen)
    try:
        launches = smoke._serve_family(cpu, smoke.LLAMA4, use_reduced=True,
                                       param_dtype="bfloat16")
        launches.update(smoke._deploy(cpu, use_reduced=True))
        launches.update(smoke._serve_stablelm_bf16(cpu, use_reduced=True))
    finally:
        ops.flash_attention, ops.paged_attention, ops.rmsnorm = (
            flash, paged, norm)
    launches.update(smoke._ckpt_resume(
        cpu, use_reduced=True, where=tmp_path_factory.mktemp("ckpt")))
    return launches, seen


def test_phase11_runs_on_the_cpu(smoke, phase11_on_the_cpu):
    launches, _ = phase11_on_the_cpu
    assert set(smoke.BF16_PATHS) - {"train:11a"} <= set(launches)
    assert "train:11d" in launches
    assert all(n == 0 for c in launches.values() for n in c.values())


def test_phase2_holds_every_shape_phase11_gives(smoke, phase11_on_the_cpu):
    """Phase 2 holds each kernel at every shape and dtype 11b and 11c
    launch it at, with the full configs' heads and widths: K1 at llama4's
    one-prompt prefills of phase 3's mix, K2 at its heads on phase 3's
    paged table, K3 at every row count and dtype of both (d_model 5120),
    B2-B4 at each of 11b's microbatches in each dtype."""
    from repro_torch.bench.suites import batch_precision
    from repro_torch.configs import get_arch
    _, seen = phase11_on_the_cpu
    cfg, qwen = get_arch(smoke.LLAMA4), batch_precision.config(False)
    assert cfg.d_model == qwen.d_model
    k1 = {(b, sq, sk, causal, "bfloat16") for b, sq, sk, _, _, _, causal
          in smoke.LLAMA4_K1}
    assert {(b, sq, sk, causal, dt) for b, sq, sk, causal, window, dt
            in seen["K1"] if window == 0} <= k1
    assert all(window == 0 for *_, window, _ in seen["K1"])
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert {k[3:6] for k in smoke.LLAMA4_K1} == {heads}
    assert set(seen["K2"]) == {(4, 16, 10, 41, "bfloat16")}
    assert set(smoke.LLAMA4_K2) == {heads}
    assert {(rows, cfg.d_model, dt) for rows, _, dt in seen["K3"]} <= {
        (rows, d, dt) for dt, shapes in smoke.SLICE_K3.items()
        for rows, d in shapes}
    b2 = {(b, s, s, causal, dt) for dt, shapes in smoke.DEPLOY_ATTN.items()
          for b, s, *_, causal in shapes}
    assert set(seen["B2-B4"]) <= b2
    assert {a[2:5] for shapes in smoke.DEPLOY_ATTN.values()
            for a in shapes} == {(qwen.num_heads, qwen.num_kv_heads,
                                  qwen.resolved_head_dim)}
    # every batch the suite runs, in each dtype it runs it in
    assert {(b, dt) for b, _, _, _, dt in seen["B2-B4"]} == {
        *((b, "float32") for b in smoke.DEPLOY_BATCHES), (8, "bfloat16")}


def test_phase2_holds_the_training_and_norm_shapes_of_6e_and_10f(smoke):
    """Phase 2's lines at stablelm-12b's training microbatch (B2-B4, f32,
    as 6e's steps launch them) and at qwen1.5-110b's norm over a prompt
    of phase 3's mix (K3, d_model 8192, f32)."""
    from repro_torch.configs import get_arch
    rcfg = smoke._train_config("6e", "kernel")
    cfg = rcfg.model
    rows = smoke.TRAIN_BATCH // rcfg.microbatches
    assert smoke.STABLELM_ATTN == ((
        rows, rcfg.shape.seq_len, cfg.num_heads, cfg.num_kv_heads,
        cfg.resolved_head_dim, True),)
    assert cfg.resolved_head_dim == 160
    prompts = {len(r.prompt) for r in smoke._request_mix(cfg)}
    assert smoke.QWEN15_K3 == ((max(prompts), get_arch(smoke.QWEN15).d_model),)


def test_phase12_is_wired(smoke):
    """Phase 12 runs after phase 11 and before phase 8, its paths' launches
    are required by the kernels line's check, and each of 12a's scenarios
    names the kernel whose records it holds."""
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main()"):src.index("def _missing(")]
    assert main.index("_bf16_phases(dev)") < main.index(
        "_inter_chip(dev, summary)") < main.index("_bench(dev, tier1)")
    assert "PHASE12_PATHS" in src[src.index("def _missing("):]
    from repro_torch.bench import select
    from repro_torch.bench.suites import kernels
    from repro_torch.kernels import ops
    assert set(kernels.KERNEL_OF) == {s.name for s in select(
        only="kernels")}
    assert set(kernels.KERNEL_OF.values()) <= set(ops.KERNELS)


@pytest.fixture(scope="module")
def phase12_on_the_cpu(smoke):
    """Phases 12b-12d on the reference's reduced configs and small
    shapes over a world-size-1 gloo group on the CPU (their gates raise
    on failure); 12a and 12e run only on the card."""
    torch.set_num_threads(2)
    return smoke._inter_chip(torch.device("cpu"), use_reduced=True)


def test_phase12_runs_on_the_cpu(smoke, phase12_on_the_cpu):
    launches = phase12_on_the_cpu
    assert set(launches) == set(smoke.PHASE12_PATHS)
    assert all(n == 0 for c in launches.values() for n in c.values())
    import torch.distributed as dist
    assert not dist.is_initialized()      # the phase's group is gone


def test_phase12_gates_trip(smoke, monkeypatch):
    """12c's gate catches partials that are combined wrongly, and 12b's
    wrapper check a collective that is not the identity over one rank."""
    from repro_torch.parallel import collectives as coll
    combine = coll.combine_partials
    monkeypatch.setattr(coll, "combine_partials", lambda parts, *a, **k: (
        combine(parts[:1] if isinstance(parts, list) else parts, *a, **k)))
    from repro_torch.configs import MeshConfig
    from repro_torch.launch.mesh import init_world, make_mesh
    import tempfile
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as d:
        init_world("cpu", store_dir=d, rank=0, world_size=1)
        try:
            mesh = make_mesh(MeshConfig(shape=(1, 1),
                                        axes=("data", "model")), "cpu")
            with pytest.raises(AssertionError, match="12c"):
                smoke._decode_shards(torch.device("cpu"), mesh, True)
            monkeypatch.setattr(coll, "combine_partials", combine)
            monkeypatch.setattr(coll, "all_reduce",
                                lambda t, *a, **k: t * 2)
            ok = smoke._collective_wrappers(torch.device("cpu"), mesh)
            assert not ok["all_reduce"] and not ok["copy_to"]
        finally:
            dist.destroy_process_group()


# ------------------------------------------------------------- phase 13
def _count(**kw):
    base = {"flops": 1e12, "dot_flops": 8e11, "bytes": 3e10,
            "collectives": {"all-reduce": 4e6, "all-gather": 2e6},
            "kernels": {"rmsnorm": 9, "flash_attention_lse": 4}}
    return {**base, **kw}


def test_count_problems(smoke):
    """13a's rule: totals and collective bytes within COUNT_TOL relative,
    kernel calls exactly."""
    assert smoke.count_problems(_count(), _count()) == []
    assert smoke.count_problems(_count(), _count(flops=1e12 * (1 + 5e-10))) \
        == []
    (p,) = smoke.count_problems(_count(), _count(bytes=3e10 * (1 + 2e-9)))
    assert p.startswith("bytes:")
    (p,) = smoke.count_problems(_count(), _count(collectives={
        "all-reduce": 4e6, "all-gather": 2e6, "reduce-scatter": 1.0}))
    assert p.startswith("reduce-scatter bytes")
    (p,) = smoke.count_problems(_count(), _count(kernels={
        "rmsnorm": 9, "flash_attention_lse": 5}))
    assert p.startswith("kernel calls")
    assert smoke.COUNT_TOL == 1e-9 and smoke.PEAK_TOL == 0.10


def test_resume_problems(smoke):
    """13b's rule, phase 11d's: every later step's loss and grad norm bit
    for bit, or within two unbroken runs' difference; as many steps; the
    final params likewise."""
    run = [(2.5, 1.0), (2.4, 0.9), (2.3, 0.8), (2.2, 0.7)]
    assert smoke.resume_problems(run, run, run[2:], 2) == []
    assert smoke.resume_problems(run, run, run, 0) == []
    off = [(2.3, 0.8), (2.2, 0.7000001)]
    (p,) = smoke.resume_problems(run, run, off, 2)
    assert p.startswith("step 3:")
    noisy = run[:3] + [(2.2, 0.7000002)]
    assert smoke.resume_problems(run, noisy, off, 2) == []
    (p,) = smoke.resume_problems(run, run, run[2:3], 2)
    assert "resumed steps" in p
    (p,) = smoke.resume_problems(run, run, run[2:], 2, 1e-7, 0.0)
    assert p.startswith("final params differ")
    assert smoke.resume_problems(run, run, run[2:], 2, 1e-7, 2e-7) == []


def test_phase13_is_wired(smoke):
    """Phase 13 runs after phase 12 and before phase 8, and its paths'
    launches are required by the kernels line's check."""
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main()"):src.index("def _missing(")]
    assert main.index("_inter_chip(dev, summary)") < main.index(
        "_dry_run(dev)") < main.index("_bench(dev, tier1)")
    assert "PHASE13_PATHS" in src[src.index("def _missing("):]
    assert smoke.DRYRUN_CELLS == (("granite-3-8b", "train_4k", False),
                                  ("arctic-480b", "decode_32k", True))


def test_phase13_runs_on_the_cpu(smoke):
    """13a's gate and 13b's remesh on the reduced granite over a
    world-size-1 gloo group on the CPU (their gates raise on failure;
    the dry run's cells, the launcher and 13c run only on the card)."""
    import torch.distributed as dist
    # one thread: the CPU's threaded reductions are not deterministic from
    # run to run, and 13b holds a resumed run bit for bit
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = smoke._dry_run(torch.device("cpu"), use_reduced=True)
    finally:
        torch.set_num_threads(threads)
    assert set(launches) == {"train:13a", "train:13b"}
    assert all(n == 0 for c in launches.values() for n in c.values())
    assert not dist.is_initialized()


def test_phase14_is_wired(smoke):
    """Phase 14 runs after phase 9 and before the kernels line, so no
    earlier phase sees its tuned cache; the launch recorder is installed
    before phase 2's first line."""
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main()"):src.index("def _missing(")]
    assert main.index("LaunchRecorder().install()") < main.index(
        "for dname, dtype in") < main.index("_serve_suite(dev)") < \
        main.index("_tuning_and_analysis(dev, recorder)") < main.index(
            'line = {"kernels": [')
    assert smoke.PHASE14_S == 60 and smoke.RESOLVE_CALLS == 10000


def test_limits_problems(smoke):
    from repro_torch.core.roofline import H100
    lim = H100.limits
    attrs = {f: tuple(getattr(lim, f) for _ in codes)
             for f, codes in smoke.DEVICE_ATTRS.items()}
    props = {f: getattr(lim, f) for f in smoke.DEVICE_PROPS}
    assert smoke.limits_problems(lim, attrs, props, 8) == []
    assert len(smoke.limits_problems(
        lim, {**attrs, "grid_yz": (65535, 1024)}, {**props, "sms": 114},
        4)) == 3


def _lint_query(name, *args):
    """The lint's own plan where the card answers the C plan query."""
    from repro_torch.analysis import kernel_lint
    kernel = {"flash_attention_fwd": "flash_attention",
              "flash_attention_dq": "flash_attention",
              "flash_attention_dkv": "flash_attention",
              "paged_attention": "paged_attention_fwd", "wkv6": "wkv6_fwd",
              "rmsnorm": "rmsnorm_fwd"}[name]
    for dims in kernel_lint.CANONICAL_DIMS[kernel]:
        for p in kernel_lint.plans(kernel, dims, kernel_lint.default_config(
                kernel, dims)):
            # the parameter (last) is 0 in the query: the C heuristic
            same = (p.query_args == args if kernel == "flash_attention"
                    else p.query_args[:-1] == args[:-1])
            if p.query == name and same:
                return p.launch()
    raise KeyError((name, args))


def _records():
    from repro_torch.analysis import kernel_lint
    out = set()
    for kernel, shapes in kernel_lint.CANONICAL_DIMS.items():
        for dims in shapes:
            cfg = kernel_lint.default_config(kernel, dims)
            passed = next(iter(cfg.items())) if cfg else None
            if kernel == "rmsnorm_fwd":
                dims = {**dims, "aligned": 1}
            out.add((kernel, tuple(dims.items()), passed))
    return out


def test_plan_problems_hold_each_launch(smoke):
    problems, n = smoke.plan_problems(_records(), _lint_query)
    # K1/B2, B3 and B4 at five shapes in two dtypes; K2, B6, K3
    assert problems == [] and n == 3 * 10 + 6 + 4 + 6

    def off(name, *args):
        plan = dict(_lint_query(name, *args))
        if name == "wkv6":
            plan["smem"] += 16
        return plan
    problems, _ = smoke.plan_problems(_records(), off)
    assert len(problems) == 4 and all("B6" in p for p in problems)
    records = {(k, d, ("splits", 8) if p and p[0] == "splits" else p)
               for k, d, p in _records()}
    problems, _ = smoke.plan_problems(records, _lint_query)
    # 8 is the heuristic's own pick at batch 1: the other 4 K2 records
    assert sum("passed ('splits', 8)" in p for p in problems) == 4


def test_the_launch_recorder_keys_and_restores(smoke, monkeypatch):
    from repro_torch.kernels import (flash_attention, paged_attention,
                                     rmsnorm, wkv6)
    for module, name in ((flash_attention, "flash_attention_cuda"),
                         (paged_attention, "paged_attention_cuda"),
                         (wkv6, "wkv6_cuda"), (rmsnorm, "rmsnorm_cuda")):
        monkeypatch.setattr(module, name, lambda *a, **k: "ran")
    fakes = {n: getattr(m, n) for m, n in (
        (flash_attention, "flash_attention_cuda"),
        (rmsnorm, "rmsnorm_cuda"))}
    rec = smoke.LaunchRecorder().install()
    try:
        q = torch.zeros(1, 8, 4, 64)
        assert flash_attention.flash_attention_cuda(
            q, q[:, :, :2], q[:, :, :2], causal=True, window=0) == "ran"
        x = torch.zeros(4, 64)
        rmsnorm.rmsnorm_cuda(x, torch.ones(64), 1e-5, 96)
        pq = torch.zeros(2, 1, 4, 64)
        pool = torch.zeros(9, 16, 2, 64)
        bt = torch.ones(2, 4, dtype=torch.int32)
        paged_attention.paged_attention_cuda(pq, pool, pool, bt, bt[:, 0], 2)
        wq = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
        wkv6.wkv6_cuda(wq, wq, wq, torch.zeros(1, 8, 2, 16), None, 16)
    finally:
        rec.remove()
    assert flash_attention.flash_attention_cuda is \
        fakes["flash_attention_cuda"]
    assert rmsnorm.rmsnorm_cuda is fakes["rmsnorm_cuda"]
    keys = {(k, dict(d).get("dtype"), p) for k, d, p in rec.seen}
    assert keys == {("flash_attention", "float32", None),
                    ("rmsnorm_fwd", "float32", ("threads", 96)),
                    ("paged_attention_fwd", "float32", ("splits", 2)),
                    ("wkv6_fwd", "bfloat16", ("v_slice", 16))}


@pytest.mark.parametrize("kernel", ["paged_attention_fwd", "wkv6_fwd",
                                    "rmsnorm_fwd"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_phase14_sweep_helpers_on_the_cpu(smoke, kernel, dname):
    """14b's inputs, plain versions, calls and gates at small shapes on
    the CPU (the wrappers run their plain versions), and 14c's
    resolution with no cache: the heuristic."""
    from repro_torch.kernels import tuning
    dims = {"paged_attention_fwd": dict(B=4, Hq=4, Hkv=2, D=64, P=64,
                                        ps=16, npag=16, dtype=dname),
            "wkv6_fwd": dict(B=1, T=70, H=2, K=16, V=16, u=1, dtype=dname,
                             ld="float32"),
            "rmsnorm_fwd": dict(rows=5, d=96, dtype=dname)}[kernel]
    args = smoke._sweep_inputs(kernel, getattr(torch, dname),
                               torch.device("cpu"), dims)
    want, plain = smoke._plain(kernel, args)
    cands, _, dflt = smoke._candidates_at(kernel, dims)
    for cfg in cands:
        out = smoke._call(kernel, args, cfg[tuning.PARAMS[kernel]])
        line = smoke._held_line(kernel, out, want, dname)
        # the CPU's plain versions round in bf16, where the kernels keep
        # f32: the one-unit gate is the card's
        assert line["ok"] or dname == "bfloat16"
        assert smoke._same(out, smoke._call(kernel, args))
    assert smoke._resolve(kernel, dims, args) == \
        dflt[tuning.PARAMS[kernel]]
    plain()
