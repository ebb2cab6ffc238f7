"""The checks of ``chip_smoke.py`` that need no card: phase 2's bf16 gate in
units of bf16 rounding, and phase 1's reading of the kernel instances
(K1/B2, B3, B4, B6, K2, K3) from their mangled names, and the profiler's kernel
groups against the kernels the port defines."""
import importlib.util
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
