"""The port's section engine (``repro_torch.core.sections``) and Tier-1
profile (``repro_torch.core.profiler``) against the JAX package's: with
the TPU's constants injected as a ``Chip``, allocation, LI, section count
and runtime equal the JAX module's (rel 1e-12) for all ten archs x the
four shapes x two meshes x O0/O1/O3; with the H100's, they equal the JAX
module evaluated at the H100's constants, so the two differ only through
them. Plus ``tests/test_metrics.py``'s partitioner invariants."""
import dataclasses

import pytest

import jax  # noqa: F401  (the test files import both packages)

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import MeshConfig as JaxMesh
from repro.core import profiler as jprof
from repro.core import sections as jsec
from repro_torch.configs import ARCHS, SHAPES, MeshConfig
from repro_torch.core import profiler, sections
from repro_torch.core.cost import CostReport
from repro_torch.core.roofline import H100

from test_torch_metrics import TPU  # noqa: E402  (the JAX constants)

REL = 1e-12
MESHES = {"16x16": (16, 16), "1x1": (1, 1)}
MODES = ("O0", "O1", "O3")


def _same(got, want):
    assert got.mode == want.mode and got.n_sections == want.n_sections
    for key in ("allocation", "load_imbalance", "total_runtime"):
        assert getattr(got, key) == pytest.approx(getattr(want, key),
                                                  rel=REL), key


def test_configs_are_the_jax_package_configs():
    assert sorted(ARCHS) == sorted(JAX_ARCHS) and len(ARCHS) == 10
    for name in ARCHS:
        assert dataclasses.asdict(ARCHS[name]) == \
            dataclasses.asdict(JAX_ARCHS[name])
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_sections_with_the_tpu_chip_equal_jax(arch, mesh):
    for shape in SHAPES:
        for mode in MODES:
            got = sections.analyze(ARCHS[arch], SHAPES[shape],
                                   MeshConfig(MESHES[mesh]), mode, TPU)
            want = jsec.analyze(JAX_ARCHS[arch], JAX_SHAPES[shape],
                                JaxMesh(MESHES[mesh]), mode)
            _same(got, want)


@pytest.mark.parametrize("arch", ["granite-3-8b", "hymba-1.5b", "rwkv6-3b",
                                  "arctic-480b"])
def test_h100_sections_differ_from_jax_only_by_the_constants(arch,
                                                             monkeypatch):
    """The JAX module at the H100's bf16 peak and memory rate gives the
    port's H100 numbers: nothing but the constants differs."""
    monkeypatch.setattr(jsec, "PEAK_FLOPS_BF16", H100.peak("bfloat16"))
    monkeypatch.setattr(jsec, "HBM_BW", H100.hbm_bw)
    for mesh in MESHES.values():
        for mode in MODES:
            _same(sections.analyze(ARCHS[arch], SHAPES["train_4k"],
                                   MeshConfig(mesh), mode),
                  jsec.analyze(JAX_ARCHS[arch], JAX_SHAPES["train_4k"],
                               JaxMesh(mesh), mode))


def test_f32_graph_doubles_the_bf16_widths():
    cfg, shape, mesh = ARCHS["granite-3-8b"], SHAPES["train_4k"], MeshConfig()
    bf = sections.build_op_graph(cfg, shape, mesh)
    f32 = sections.build_op_graph(cfg, shape, mesh, "float32")
    for a, b in zip(bf, f32):
        assert a.flops == b.flops
        if a.unit == "mma":     # norms and logits are f32 in both
            assert a.bytes < b.bytes <= 2 * a.bytes
        else:
            assert a.bytes == b.bytes
    assert sum(b.bytes for b in f32 if b.name.endswith(".mlp")) == \
        2 * sum(a.bytes for a in bf if a.name.endswith(".mlp"))
    rep = sections.analyze(cfg, shape, mesh, "O3", H100, "float32")
    assert rep.total_runtime > sections.analyze(cfg, shape, mesh,
                                                "O3").total_runtime


def test_model_flops_for_equal_jax():
    for arch in ARCHS:
        for shape in SHAPES:
            assert profiler.model_flops_for(ARCHS[arch], SHAPES[shape]) == \
                jprof.model_flops_for(JAX_ARCHS[arch], JAX_SHAPES[shape])


# ------------------------------------------------ test_metrics' invariants
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["granite-3-8b", "arctic-480b", "rwkv6-3b"])
def test_section_partitioner(mode, arch):
    cfg = ARCHS[arch]
    rep = sections.analyze(cfg, SHAPES["train_4k"], MeshConfig(), mode)
    assert 0 < rep.allocation <= 1.0
    assert 0 < rep.load_imbalance <= 1.0
    assert rep.total_runtime > 0
    if mode == "O0":
        assert rep.n_sections > cfg.num_layers


def test_sections_flops_conserved():
    ops = sections.build_op_graph(ARCHS["granite-3-8b"], SHAPES["train_4k"],
                                  MeshConfig())
    total = sum(o.flops for o in ops)
    for mode in MODES:
        assert sum(s.flops for s in sections.partition(ops, mode)) == \
            pytest.approx(total)


def test_section_graph_tracks_model_flops():
    cfg, shape = ARCHS["granite-3-8b"], SHAPES["train_4k"]
    total = sum(o.flops for o in sections.build_op_graph(cfg, shape,
                                                         MeshConfig()))
    model = 6.0 * cfg.param_count() * shape.global_batch * shape.seq_len
    assert 0.5 < total / model < 2.0


# --------------------------------------------------------- Tier-1 report
def test_tier1_report_with_the_tpu_chip_equals_jax():
    """profile() with a counted report equal to the JAX reader's gives the
    JAX report's numbers (mma_busy where JAX has mxu_busy)."""
    from repro.core.hlo_analysis import CostReport as JaxCostReport
    cfg, shape, mesh = ARCHS["granite-3-8b"], SHAPES["train_4k"], (16, 16)
    nums = dict(flops=3.1e17, dot_flops=2.9e17, bytes=4.4e14)
    got = profiler.profile(cfg, shape, MeshConfig(mesh), CostReport(**nums),
                           chip=TPU).to_dict()
    want = jprof.profile(JAX_ARCHS[cfg.name], JAX_SHAPES[shape.name],
                         JaxMesh(mesh), hlo_report=JaxCostReport(**nums)
                         ).to_dict()
    for m in MODES:
        for key, value in want["sections"][m].items():
            assert got["sections"][m][key] == (
                value if key == "mode" else pytest.approx(value, rel=REL))
    assert got["arithmetic_intensity"] == pytest.approx(
        want["arithmetic_intensity"], rel=REL)
    assert got["mma_busy_fraction"] == pytest.approx(
        want["mxu_busy_fraction"], rel=REL)
    for key in ("compute_s", "memory_s", "mfu", "useful_flops_ratio"):
        assert got["roofline"][key] == pytest.approx(want["roofline"][key],
                                                     rel=REL)


def test_tier1_measured_part_and_records():
    cfg = dataclasses.replace(ARCHS["granite-3-8b"], num_layers=8)
    from repro_torch.configs import ShapeConfig
    shape = ShapeConfig("train", "train", 4096, 2)
    cost = CostReport(flops=1.2e14, dot_flops=1.1e14, bytes=3e11)
    rep = profiler.profile(cfg, shape, MeshConfig((1, 1)), cost,
                           measured={"step_s": 2.5, "device_busy_share": 0.99,
                                     "top_kernels_ms": [["x", 1.0]]},
                           dtype="float32")
    model = 6.0 * cfg.param_count() * 2 * 4096
    m = rep.to_dict()["measured"]
    assert m["mfu_measured"] == pytest.approx(model / (67e12 * 2.5))
    assert m["device_busy_share"] == 0.99 and "top_kernels_ms" not in m
    assert rep.roofline["compute_s"] == pytest.approx(1.2e14 / 67e12)
    assert rep.roofline["useful_flops_ratio"] == pytest.approx(model / 1.2e14)
    recs = rep.to_records()
    assert [r.name for r in recs] == [
        f"tier1/granite-3-8b/train/{m}" for m in MODES] + [
        "tier1/granite-3-8b/train/roofline"]
    assert recs[-1].derived["mfu_measured"] == pytest.approx(
        m["mfu_measured"])
    assert set(recs[0].derived) == {"allocation", "LI", "n_sections",
                                    "runtime_s"}
