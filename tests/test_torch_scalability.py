"""The port's Tier-2 analysis (``repro_torch/core/scalability.py``,
``core/mesh_advisor.py``, ``runtime/elastic.py::choose_mesh``,
``parallel/pipeline.py``'s analytic functions) against the JAX
package's: every function equal to 1e-12 on the same inputs; the advisor,
given a ``Chip`` built here from the reference's constants, reproduces
the reference's terms and rankings (and ``tests/test_advisor.py``'s
findings); under the H100 every chosen mesh fits its 80 GB.
"""
import importlib

import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.core import mesh_advisor as jadv
from repro.core import scalability as jscal
from repro.parallel import pipeline as jpipe
from repro.runtime.elastic import choose_mesh as jchoose
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.core import mesh_advisor as adv
from repro_torch.core import scalability as scal
from repro_torch.core.roofline import H100, Chip
from repro_torch.parallel import pipeline as pipe
from repro_torch.runtime.elastic import choose_mesh

# ``repro.core`` exports a function under the module's name
jroof = importlib.import_module("repro.core.roofline")
TOL = 1e-12
LAYOUTS = [(2, 2, 2, 2), (1, 2, 2, 3), (1, 1, 1, 5), (8,), (3, 1), (0, 4)]
# the reference's chip, from its own constants
REF_CHIP = Chip(name="reference", peak_flops={"bfloat16":
                                              jroof.PEAK_FLOPS_BF16},
                hbm_bw=jroof.HBM_BW, hbm_bytes=jroof.HBM_PER_CHIP,
                link_bw=jroof.ICI_BW_PER_LINK)


def _close(a, b):
    assert abs(a - b) <= TOL * max(1.0, abs(b)), (a, b)


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_pipeline_models_match_jax(layout):
    for m in (1, 4, 8, 32):
        if min(layout) > 0:
            _close(scal.pp_bottleneck_model(layout, 0.013, m),
                   jscal.pp_bottleneck_model(layout, 0.013, m))
            _close(scal.pp_throughput_ratio(layout, m),
                   jscal.pp_throughput_ratio(layout, m))
            _close(pipe.pipeline_step_time(layout, 0.013, m),
                   jpipe.pipeline_step_time(layout, 0.013, m))
            _close(scal.pp_calibrate_per_layer(0.7, layout, m),
                   jscal.pp_calibrate_per_layer(0.7, layout, m))
            got = scal.pp_model_check(0.5, layout, m, 0.01)
            want = jscal.pp_model_check(0.5, layout, m, 0.01)
            _close(got.ratio, want.ratio)
            assert got.within() == want.within()
            assert got.within(0.9, 1.1) == want.within(0.9, 1.1)
    _close(scal.pp_stage_balance(layout), jscal.pp_stage_balance(layout))
    assert pipe.stage_utilization(layout) == pytest.approx(
        jpipe.stage_utilization(layout), abs=TOL)
    _close(pipe.pipeline_allocation(layout),
           jpipe.pipeline_allocation(layout))
    if sum(layout) and min(layout) > 0:
        assert pipe.stage_layout(sum(layout), layout) == \
            jpipe.stage_layout(sum(layout), layout)


def test_scaling_metrics_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        a, b = (float(x) for x in rng.uniform(0, 3, 2))
        _close(scal.scaling_efficiency(a, b), jscal.scaling_efficiency(a, b))
        _close(scal.collective_time_fraction(a, b),
               jscal.collective_time_fraction(a, b))
    for a, b in ((1.0, 0.0), (0.0, 1.0), (0.0, 0.0)):
        _close(scal.scaling_efficiency(a, b), jscal.scaling_efficiency(a, b))
        _close(scal.collective_time_fraction(a, b),
               jscal.collective_time_fraction(a, b))
    for total in (0, 1, 7, 32, 33):
        for shards in (1, 3, 8, 40):
            assert scal.even_shard_sizes(total, shards) == \
                jscal.even_shard_sizes(total, shards)
            _close(scal.shard_balance(scal.even_shard_sizes(total, shards)),
                   jscal.shard_balance(jscal.even_shard_sizes(total, shards)))
    work = list(rng.uniform(0.1, 5, 9))
    _close(scal.shard_balance(work), jscal.shard_balance(work))
    _close(scal.shard_balance([]), jscal.shard_balance([]))


def test_measure_sweeps_time_each_point():
    """The sweeps' points, as the reference names them; the timer runs
    the step ``warmup + iters`` times and takes the median."""
    calls = []

    def builder(b):
        return (lambda x: calls.append(x)), (b,), 64 * b

    pts = scal.measure_batch_sweep(builder, [1, 4])
    assert [p.name for p in pts] == ["batch1", "batch4"]
    assert [p.extras for p in pts] == [{"batch": 1}, {"batch": 4}]
    assert all(p.devices == 1 and p.step_time_s > 0 for p in pts)
    assert all(p.throughput == pytest.approx(64 * p.extras["batch"]
                                             / p.step_time_s) for p in pts)
    assert len(calls) == 2 * (2 + 5)
    pts = scal.measure_precision_sweep(lambda dt: ((lambda: None), (), 10))
    assert [p.name for p in pts] == ["float32", "bfloat16"]
    assert [p.extras["dtype"] for p in pts] == ["float32", "bfloat16"]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 12, 16, 64, 256, 512])
def test_choose_mesh_matches_jax(n):
    for prefer in (0, 2, 8):
        got, want = choose_mesh(n, prefer_model=prefer), jchoose(
            n, prefer_model=prefer)
        assert (got.shape, got.axes) == (want.shape, want.axes)


def _terms(a):
    return (a.mesh.shape, a.microbatches, a.compute_s, a.memory_s,
            a.collective_s, a.hbm_gb, a.fits)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_advisor_matches_jax_with_its_chip(arch, shape):
    cal = {"flops_per_s": 1.1e14, "useful_flops_scale": 1.3}
    for n, kw in ((256, {}), (64, {"seqs_per_device": 2}),
                  (256, {"calibration": cal}), (512, {})):
        got = adv.advise(ARCHS[arch], SHAPES[shape], n, chip=REF_CHIP, **kw)
        want = jadv.advise(JAX_ARCHS[arch], JAX_SHAPES[shape], n, **kw)
        assert [a.mesh.shape for a in got] == [a.mesh.shape for a in want]
        for g, w in zip(got, want):
            tg, tw = _terms(g), _terms(w)
            assert tg[:2] == tw[:2] and tg[-1] == tw[-1]
            for x, y in zip(tg[2:-1], tw[2:-1]):
                _close(x, y)
            assert g.dominant == w.dominant
    g = adv.best_mesh(ARCHS[arch], SHAPES[shape], chip=REF_CHIP)
    w = jadv.best_mesh(JAX_ARCHS[arch], JAX_SHAPES[shape])
    assert (g.mesh.shape, g.fits) == (w.mesh.shape, w.fits)
    _close(g.step_s, w.step_s)


def test_advisor_findings_hold_with_the_reference_chip():
    """tests/test_advisor.py's rankings, from the port's advisor."""
    def rank(a):
        return [x.mesh.shape for x in adv.advise(ARCHS[a], SHAPES["train_4k"],
                                                 chip=REF_CHIP)]
    r = rank("qwen1.5-110b")
    assert r.index((64, 4)) < r.index((16, 16))
    assert r.index((32, 8)) < r.index((16, 16))
    r = rank("rwkv6-3b")
    assert r[0][1] <= 2 and r.index((256, 1)) < r.index((16, 16))
    r = rank("arctic-480b")
    assert r.index((4, 64)) < r.index((32, 8))
    assert adv.best_mesh(ARCHS["qwen1.5-110b"], SHAPES["train_4k"],
                         chip=REF_CHIP).fits


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_h100_choices_fit_80gb(arch):
    assert H100.hbm_bytes == 80e9
    for shape in ("train_4k", "prefill_32k"):
        for n in (64, 256, 512):
            best = adv.best_mesh(ARCHS[arch], SHAPES[shape], n)
            assert best.fits and best.hbm_gb * 1e9 <= H100.hbm_bytes
            ranked = adv.advise(ARCHS[arch], SHAPES[shape], n)
            assert all(a.fits == (a.hbm_gb * 1e9 <= 80e9) for a in ranked)
            cs = {round(a.compute_s, 9) for a in ranked}
            assert len(cs) == 1       # same flops over the same chips
