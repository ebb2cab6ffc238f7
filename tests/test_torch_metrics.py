"""The port's Tier-1 metrics (``repro_torch.core.metrics``) and roofline
(``repro_torch.core.roofline``) against the JAX package's, on the same
seeded numpy inputs (rel 1e-12), with the TPU's constants injected as a
``Chip`` where a peak is read; plus the invariants of
``tests/test_metrics.py`` and the H100's own constants."""
import importlib

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import jax  # noqa: F401  (the test files import both packages)

from repro.core import metrics as jm
from repro.core.hlo_analysis import CollectiveOp as JaxCollectiveOp
from repro.core.hlo_analysis import CostReport as JaxCostReport
from repro_torch.core import metrics as tm
from repro_torch.core import roofline as tr
from repro_torch.core.cost import CollectiveOp, CostReport

# the module: the package ``repro.core`` exports a function of its name
jr = importlib.import_module("repro.core.roofline")
settings.register_profile("torch_metrics", max_examples=50, deadline=None)
settings.load_profile("torch_metrics")
REL = 1e-12
TPU = tr.Chip(name="tpu (the JAX package's constants)",
              peak_flops={"bfloat16": jr.PEAK_FLOPS_BF16},
              hbm_bw=jr.HBM_BW, hbm_bytes=jr.HBM_PER_CHIP,
              link_bw=jr.ICI_BW_PER_LINK,
              mma_tiles={"bfloat16": jm.MXU_TILE})


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("seed", range(4))
def test_equations_equal_jax(seed):
    rng = _rng(seed)
    n = int(rng.integers(1, 12))
    res, thr = rng.uniform(0.1, 8, n), rng.uniform(0.01, 50, n)
    runtimes = rng.uniform(0.0, 3, n)
    used, alls = rng.uniform(0, 100, n), rng.uniform(1, 100, n)
    secs = list(zip(runtimes, used, alls))
    assert tm.allocation_ratio(used[0], alls[0]) == pytest.approx(
        jm.allocation_ratio(used[0], alls[0]), rel=REL)
    assert tm.weighted_allocation(secs) == pytest.approx(
        jm.weighted_allocation(secs), rel=REL)
    assert tm.load_imbalance(res, thr) == pytest.approx(
        jm.load_imbalance(res, thr), rel=REL)
    li = list(zip(runtimes, rng.uniform(0, 1, n)))
    assert tm.weighted_load_imbalance(li) == pytest.approx(
        jm.weighted_load_imbalance(li), rel=REL)
    P, B, S, d, L = (float(rng.uniform(1e6, 1e10)), int(rng.integers(1, 64)),
                     int(rng.integers(16, 8192)), int(rng.integers(64, 8192)),
                     int(rng.integers(1, 80)))
    act = tm.activation_bytes_estimate(L, B, S, d)
    assert act == pytest.approx(jm.activation_bytes_estimate(L, B, S, d),
                                rel=REL)
    assert tm.arithmetic_intensity(P, B, S, act) == pytest.approx(
        jm.arithmetic_intensity(P, B, S, act), rel=REL)
    tasks = [tm.TaskStat(f"t{i}", r, t) for i, (r, t) in
             enumerate(zip(res, thr))]
    jtasks = [jm.TaskStat(f"t{i}", r, t) for i, (r, t) in
              enumerate(zip(res, thr))]
    assert tm.li_over_tasks(tasks) == pytest.approx(
        jm.li_over_tasks(jtasks), rel=REL)
    load = rng.integers(0, 50, int(rng.integers(1, 16))).astype(float)
    assert tm.expert_load_imbalance(load) == pytest.approx(
        jm.expert_load_imbalance(load), rel=REL)
    slots = rng.integers(0, 40, n)
    assert tm.slot_load_balance(slots) == pytest.approx(
        jm.slot_load_balance(slots), rel=REL)
    s = sorted(rng.uniform(0, 1, n))
    assert tm.percentile(s, 95.0) == pytest.approx(jm.percentile(s, 95.0),
                                                   rel=REL)


def test_expert_load_imbalance_edge_cases_equal_jax():
    for load in ([0, 0, 0], [5, 0, 5], [1, 1, 1, 1], [3], []):
        assert tm.expert_load_imbalance(np.array(load, float)) == \
            jm.expert_load_imbalance(np.array(load, float))


@pytest.mark.parametrize("seed", range(3))
def test_tile_efficiency_with_the_tpu_tile_equals_jax(seed):
    rng = _rng(seed)
    for m, n, k in rng.integers(1, 3000, (50, 3)):
        want = jm.mxu_tile_efficiency(int(m), int(n), int(k))
        assert tm.mma_tile_efficiency(m, n, k, tile=jm.MXU_TILE) == \
            pytest.approx(want, rel=REL)
        assert tm.mma_tile_efficiency(m, n, k, dtype="bfloat16",
                                      chip=TPU) == pytest.approx(want, rel=REL)


def test_mma_tile_efficiency_on_hopper_tiles():
    # m16n8k8 (TF32, the f32 default) and m16n8k16 (bf16)
    assert tm.mma_tile_efficiency(16, 8, 8) == pytest.approx(1.0)
    assert tm.mma_tile_efficiency(8, 8, 8) == pytest.approx(0.5)
    assert tm.mma_tile_efficiency(16, 8, 8, dtype="bfloat16") == \
        pytest.approx(0.5)
    assert tm.mma_tile_efficiency(4096, 4096, 128) == pytest.approx(1.0)
    assert 0 < tm.mma_tile_efficiency(100, 100, 100) < 1


# ------------------------------------------------------ test_metrics' cases
def test_eq1_allocation():
    assert tm.allocation_ratio(92, 100) == pytest.approx(0.92)
    assert tm.allocation_ratio(0, 0) == 0.0


def test_eq2_weighted_allocation():
    secs = [(3.0, 50, 100), (1.0, 100, 100)]
    assert tm.weighted_allocation(secs) == pytest.approx(0.625)


def test_eq3_load_imbalance_exact():
    assert tm.load_imbalance([1, 1], [1, 2]) == pytest.approx(0.75)
    assert tm.load_imbalance([1, 1, 1], [5, 5, 5]) == pytest.approx(1.0)


def test_eq4_weighted_li():
    assert tm.weighted_load_imbalance(
        [(1.0, 1.0), (3.0, 0.5)]) == pytest.approx((1 + 1.5) / 4)


def test_eq5_arithmetic_intensity():
    ai = tm.arithmetic_intensity(1e8, 8, 1024, 0.0)
    assert ai == pytest.approx(6 * 1e8 * 8 * 1024 / (4e8))


@given(st.lists(st.tuples(st.floats(0.1, 100), st.floats(0.1, 100)),
                min_size=1, max_size=20))
def test_li_invariants(pairs):
    """LI in (0, 1]; ==1 iff all throughputs equal."""
    r = [p[0] for p in pairs]
    t = [p[1] for p in pairs]
    li = tm.load_imbalance(r, t)
    assert 0.0 < li <= 1.0 + 1e-9
    if len(set(round(x, 9) for x in t)) == 1:
        assert li == pytest.approx(1.0)


@given(st.lists(st.floats(0.01, 10), min_size=2, max_size=16))
def test_li_scale_invariance(ts):
    r = [1.0] * len(ts)
    assert tm.load_imbalance(r, ts) == pytest.approx(
        tm.load_imbalance(r, [t * 7.3 for t in ts]), rel=1e-9)


# ------------------------------------------------------------- roofline
def _reports(seed):
    rng = _rng(seed)
    flops, dots, nbytes = rng.uniform(1e9, 1e15, 3)
    colls = [(op, float(rng.uniform(1e3, 1e9)), int(rng.integers(1, 16)),
              float(rng.integers(1, 40)))
             for op in ("all-reduce", "all-gather", "reduce-scatter",
                        "all-to-all", "collective-permute")]
    port = CostReport(flops=flops, dot_flops=dots, bytes=nbytes,
                      collectives=[CollectiveOp(*c) for c in colls])
    jax_rep = JaxCostReport(flops=flops, dot_flops=dots, bytes=nbytes,
                            collectives=[JaxCollectiveOp(*c, name="c",
                                                         comp="main")
                                         for c in colls])
    return port, jax_rep, float(rng.uniform(1e9, 1e15)), \
        int(rng.integers(1, 512))


@pytest.mark.parametrize("seed", range(4))
def test_roofline_with_the_tpu_chip_equals_jax(seed):
    port, jax_rep, model_flops, chips = _reports(seed)
    got = tr.roofline(port, chips=chips, model_flops=model_flops,
                      dtype="bfloat16", chip=TPU).to_dict()
    want = jr.roofline(jax_rep, chips=chips,
                       model_flops=model_flops).to_dict()
    for key, value in want.items():
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, rel=REL), key
        else:
            assert got[key] == value, key
    assert got["peak_flops"] == jr.PEAK_FLOPS_BF16


def test_roofline_divides_by_the_run_dtypes_peak():
    """The compute term and the MFU of an f32 run read the f32 peak, and
    the report names it."""
    port, _, model_flops, _ = _reports(0)
    f32 = tr.roofline(port, chips=1, model_flops=model_flops)
    bf16 = tr.roofline(port, chips=1, model_flops=model_flops,
                       dtype="bfloat16")
    assert f32.compute_s == pytest.approx(port.flops / 67e12, rel=REL)
    assert bf16.compute_s == pytest.approx(port.flops / 989e12, rel=REL)
    d = f32.to_dict()
    assert (d["dtype"], d["peak_flops"]) == ("float32", 67e12)
    assert d["chip"] == tr.H100.name
    with pytest.raises(KeyError, match="no peak"):
        tr.roofline(port, chips=1, dtype="float8")


def test_h100_constants_and_roofline_helpers():
    h = tr.H100
    assert h.peak("float32") == 67e12 and h.peak("tf32") == 495e12
    assert h.peak("bfloat16") == 989e12
    assert (h.hbm_bw, h.hbm_bytes, h.link_bw) == (3.35e12, 80e9, 450e9)
    ridge = tm.ridge_intensity("float32")
    assert ridge == pytest.approx(67e12 / 3.35e12)
    assert tm.ridge_intensity("bfloat16", TPU) == pytest.approx(
        jr.PEAK_FLOPS_BF16 / jr.HBM_BW)


def test_model_flops_equal_jax():
    for fn in ("model_flops_train", "model_flops_prefill",
               "model_flops_decode"):
        assert getattr(tr, fn)(8.1e9, 4096.0) == getattr(jr, fn)(8.1e9,
                                                                 4096.0)
