"""The port's launch-parameter tuner on the CPU: the tuned cache
(``repro_torch.kernels.tuning``), the heuristics' Python mirrors against
the C launchers, the resolvers' order and memo, the sweep
(``repro_torch.bench.tune``) against the JAX package's
``repro.bench.tune._sweep`` on the same fake times, the wrappers' checks
of an explicit value, and the ``tune/*`` suite (not run on the CPU).

The kernels themselves run only on the card; their candidates against
their plain versions, and each plan query against the lint's plan, are in
``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import functools
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.bench import tune as jax_tune
from repro.kernels import tuning as jax_tuning
from repro_torch.bench import tune
from repro_torch.kernels import ops, ref, tuning

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "src" / "repro_torch" / "csrc"


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    """Point the tuned cache at a scratch dir for every test."""
    monkeypatch.setenv(tuning.ENV_VAR, str(tmp_path / "tuned"))
    tuning.clear_cache()
    yield tmp_path / "tuned"
    tuning.clear_cache()


# ------------------------------------------------------------- cache I/O
def test_cache_round_trip_hit_and_miss(isolated_cache):
    sig = tuning.rmsnorm_signature(4096, 512, torch.float32)
    key = tuning.entry_key("rmsnorm_fwd", sig)
    path = tuning.save_entries({key: {"config": {"threads": 64},
                                      "us": 1.0, "default_us": 2.0}})
    assert path == isolated_cache / "cuda.json"
    assert tuning.lookup("rmsnorm_fwd", sig) == {"threads": 64}
    other = tuning.rmsnorm_signature(128, 128, torch.float32)
    assert tuning.lookup("rmsnorm_fwd", other) is None
    assert tuning.resolve_rmsnorm_threads(
        None, rows=128, d=128, dtype=torch.float32) == \
        tuning.default_threads(128)
    assert tuning.resolve_rmsnorm_threads(
        None, rows=4096, d=512, dtype=torch.float32) == 64
    # an explicit value beats the cache
    assert tuning.resolve_rmsnorm_threads(
        128, rows=4096, d=512, dtype=torch.float32) == 128
    data = json.loads(path.read_text())
    assert data["version"] == tuning.CACHE_VERSION
    assert data["env"]["backend"] == "cuda"


@pytest.mark.parametrize("key", ["backend", "torch", "device", "sources"])
def test_cache_fingerprint_mismatch_is_ignored(isolated_cache, key):
    sig = tuning.rmsnorm_signature(64, 64, torch.float32)
    tuning.save_entries({tuning.entry_key("rmsnorm_fwd", sig):
                         {"config": {"threads": 32}}})
    assert tuning.lookup("rmsnorm_fwd", sig) == {"threads": 32}
    path = tuning.cache_path()
    data = json.loads(path.read_text())
    data["env"][key] = "elsewhere"
    path.write_text(json.dumps(data))
    tuning.clear_cache()
    assert tuning.lookup("rmsnorm_fwd", sig) is None
    assert tuning.resolve_rmsnorm_threads(
        None, rows=64, d=64, dtype=torch.float32) == 32 == \
        tuning.default_threads(64)


def test_cache_of_another_version_is_ignored(isolated_cache):
    sig = tuning.rmsnorm_signature(64, 4096, torch.float32)
    path = tuning.save_entries({tuning.entry_key("rmsnorm_fwd", sig):
                                {"config": {"threads": 64}}})
    data = json.loads(path.read_text())
    data["version"] = tuning.CACHE_VERSION + 1
    path.write_text(json.dumps(data))
    tuning.clear_cache()
    assert tuning.lookup("rmsnorm_fwd", sig) is None


def test_the_fingerprint_holds_the_sources_digest():
    from repro_torch.kernels import _build
    env = tuning._env_fingerprint()
    assert env["backend"] == "cuda" and env["torch"] == torch.__version__
    assert env["sources"] == _build._digest(_build.sources())


def test_save_merges_entries(isolated_cache):
    s1 = tuning.rmsnorm_signature(64, 64, torch.float32)
    s2 = tuning.rmsnorm_signature(128, 64, torch.float32)
    tuning.save_entries({tuning.entry_key("rmsnorm_fwd", s1):
                         {"config": {"threads": 32}}})
    tuning.save_entries({tuning.entry_key("rmsnorm_fwd", s2):
                         {"config": {"threads": 64}}})
    assert tuning.lookup("rmsnorm_fwd", s1) == {"threads": 32}
    assert tuning.lookup("rmsnorm_fwd", s2) == {"threads": 64}


def test_the_two_packages_never_read_each_others_cache(isolated_cache):
    """The reference reads ``<jax backend>.json``; the port ``cuda.json``."""
    assert tuning.cache_path().name == "cuda.json"
    assert jax_tuning.cache_path("cpu").name == "cpu.json"
    assert tuning.cache_path().parent == jax_tuning.cache_dir()


@pytest.mark.parametrize("name,args", [
    ("rmsnorm_signature", ((4096, 512, np.float32), (4096, 512,
                                                     torch.float32))),
    ("paged_attention_signature", (((4, 1, 4, 64), (64, 16, 2, 64), 16,
                                    np.float32),
                                   ((4, 1, 4, 64), (64, 16, 2, 64), 16,
                                    torch.float32))),
])
def test_signatures_are_the_references(name, args):
    jax_args, torch_args = args
    assert getattr(tuning, name)(*torch_args) == \
        getattr(jax_tuning, name)(*jax_args)


def test_the_wkv6_signature_adds_the_decay_type():
    want = jax_tuning.wkv6_signature((1, 256, 2, 64), 64, np.float32,
                                     use_u=False)
    got = tuning.wkv6_signature((1, 256, 2, 64), 64, torch.float32,
                                use_u=False, ld_dtype=torch.bfloat16)
    assert got == ",".join(sorted(want.split(",") + ["ld=bfloat16"]))


# ------------------------------------------------- the heuristics' mirrors
def _c_const(path: str, name: str) -> int:
    m = re.search(rf"constexpr (?:int|size_t) {name} = (\d+)",
                  (CSRC / path).read_text())
    assert m, (path, name)
    return int(m.group(1))


@pytest.mark.parametrize("path,name,mirror", [
    ("paged_attention.cu", "MAX_SPLIT", tuning.PAGED_MAX_SPLIT),
    ("paged_attention.cu", "VEC", tuning.PAGED_VEC),
    ("paged_attention.cu", "THREADS", tuning.PAGED_THREADS),
    ("paged_attention.cu", "NSTAGE", tuning.PAGED_NSTAGE),
    ("wkv6.cu", "CHUNK", tuning.WKV_CHUNK),
    ("wkv6.cu", "KMAX", tuning.WKV_KMAX),
    ("wkv6.cu", "THREADS", tuning.WKV_THREADS),
    ("wkv6.cu", "NF", tuning.WKV_NF),
    ("rmsnorm.cu", "ELEMS", tuning.NORM_ELEMS),
    ("rmsnorm.cu", "MAX_THREADS", tuning.NORM_MAX_THREADS),
    ("smem_opt_in.cuh", "kMaxSmem", 232448),
])
def test_mirrors_read_the_c_constants(path, name, mirror):
    assert _c_const(path, name) == mirror


def test_the_h100_limits_are_the_c_codes():
    lim = tuning.capabilities()
    assert lim.smem_per_block == _c_const("smem_opt_in.cuh", "kMaxSmem")
    assert lim.cluster == tuning.PAGED_MAX_SPLIT
    assert (lim.smem_per_sm, lim.threads_per_block, lim.sms,
            lim.grid_yz) == (233472, 1024, 132, 65535)


# the C heuristics' formulas, written out again from the C code: K2
# (``default_splits``), B6 (``choose_vs`` over ``make_layout``), K3
# (``make_plan``)
def _c_splits(B, Hq, Hkv, D, npag, sms=132):
    nc = (D // 4 + 31) // 32
    nc = 1 if nc <= 1 else 2 if nc <= 2 else 4 if nc <= 4 else 8
    gh = 4 if nc <= 2 else 8 // nc
    pairs = B * Hkv * ((Hq // Hkv + gh - 1) // gh)
    return max(1, min(8, npag, sms // pairs))


def _c_layout(K, VS, es, esl):
    ru = lambda x, m: (x + m - 1) // m * m  # noqa: E731
    rk, rl, rv = ru(K, 16 // es) + 16 // es, ru(K, 16 // esl) + 16 // esl, \
        VS + 8
    ld, ls = ru(K, 16) + 4, VS + 8
    off = 2 * (64 * rk * es * 2 + 64 * rl * esl + 64 * rv * es)
    for b in (4 * 64 * ld, 4 * 64 * ld, 4 * 64 * ld, 4 * 64 * 68,
              4 * 64 * ls, 4 * 23 * 68, 4 * 16 * 64, 4 * 64, 16, 16):
        off += ru(b, 16)
    return off


def _c_vs(B, H, K, V, es, esl, sms=132):
    widest = 0
    for vs in (16, 32, 64):
        b = _c_layout(K, vs, es, esl)
        if b > 232448:
            break
        widest = vs
        if B * H * ((V + vs - 1) // vs) <= sms * (232448 // (b + 1024)) \
                or vs >= V:
            return vs
    return widest


def _c_threads(d, V=4, aligned=True):
    vec = V if aligned and d % V == 0 else 1
    nreg = 16 // vec
    per = (d // vec + nreg - 1) // nreg
    return min(512, max(32, (per + 31) // 32 * 32))


# PERF.md's kernel table (and phase 2's other K2 tables)
PAGED_SHAPES = [(4, 32, 8, 128, 10), (4, 32, 8, 128, 256), (1, 32, 8, 128, 256),
                (4, 64, 8, 128, 10), (4, 56, 8, 128, 10), (4, 40, 8, 128, 10),
                (8, 32, 8, 128, 6), (4, 4, 2, 64, 16), (4, 64, 8, 128, 2048)]
WKV_SHAPES = [(1, 40, 64, 64), (1, 25, 16, 64), (1, 2, 64, 64),
              (4, 40, 64, 64), (1, 40, 64, 32)]
NORM_DS = [4096, 1600, 5120, 2560, 512, 256, 64, 8, 1000]


@pytest.mark.parametrize("B,Hq,Hkv,D,npag", PAGED_SHAPES)
def test_default_splits_is_the_c_heuristic(B, Hq, Hkv, D, npag):
    assert tuning.default_splits(B, Hq, Hkv, D, npag) == \
        _c_splits(B, Hq, Hkv, D, npag)


@pytest.mark.parametrize("es,esl", [(4, 4), (2, 4), (2, 2)])
@pytest.mark.parametrize("B,H,K,V", WKV_SHAPES)
def test_default_v_slice_is_the_c_heuristic(B, H, K, V, es, esl):
    assert tuning.default_v_slice(B, H, K, V, es, esl) == \
        _c_vs(B, H, K, V, es, esl)
    for vs in (16, 32, 64):
        assert tuning.wkv6_layout_bytes(K, vs, es, esl) == \
            _c_layout(K, vs, es, esl)


@pytest.mark.parametrize("d", NORM_DS)
def test_default_threads_is_the_c_heuristic(d):
    for V, aligned in ((4, True), (8, True), (4, False), (8, False)):
        assert tuning.default_threads(d) == _c_threads(d, V, aligned)


def test_the_heuristics_pick_what_the_c_comments_say():
    """K2: 4 splits at granite's decode batch of 4, 8 at batch 1; B6: V
    slices of 32 for rwkv6-3b and 16 for hymba-1.5b at batch 1; K3: 256
    threads at d 4096."""
    assert tuning.default_splits(4, 32, 8, 128, 10) == 4
    assert tuning.default_splits(1, 32, 8, 128, 256) == 8
    assert tuning.default_v_slice(1, 40, 64, 64) == 32
    assert tuning.default_v_slice(1, 25, 16, 64) == 16
    assert tuning.default_threads(4096) == 256


# --------------------------------------------------------------- resolvers
def test_resolvers_without_a_cache_give_the_heuristic():
    assert tuning.resolve_paged_splits(
        None, q_shape=(4, 1, 32, 128), pages_shape=(41, 16, 8, 128),
        n_pages=10, dtype=torch.float32) == 4
    assert tuning.resolve_wkv_v_slice(
        None, q_shape=(1, 128, 40, 64), v_head=64, dtype=torch.float32,
        use_u=True) == 32
    assert tuning.resolve_rmsnorm_threads(
        None, rows=128, d=4096, dtype=torch.float32) == 256


def test_resolvers_take_the_tuned_value_then_the_explicit_one():
    q, pages = (4, 1, 32, 128), (41, 16, 8, 128)
    tuning.save_entries({
        tuning.entry_key("paged_attention_fwd",
                         tuning.paged_attention_signature(
                             q, pages, 10, torch.float32)):
            {"config": {"splits": 2}},
        tuning.entry_key("wkv6_fwd", tuning.wkv6_signature(
            (1, 128, 40, 64), 64, torch.float32, use_u=True)):
            {"config": {"v_slice": 16}}})
    kw = dict(q_shape=q, pages_shape=pages, n_pages=10, dtype=torch.float32)
    assert tuning.resolve_paged_splits(None, **kw) == 2
    assert tuning.resolve_paged_splits(8, **kw) == 8
    assert tuning.resolve_wkv_v_slice(
        None, q_shape=(1, 128, 40, 64), v_head=64, dtype=torch.float32,
        use_u=True) == 16
    # the decay's type is part of the shape: a bf16 decay misses
    assert tuning.resolve_wkv_v_slice(
        None, q_shape=(1, 128, 40, 64), v_head=64, dtype=torch.float32,
        use_u=True, ld_dtype=torch.bfloat16) == tuning.default_v_slice(
            1, 40, 64, 64, 4, 2)


def test_splits_clamp_to_the_table():
    kw = dict(q_shape=(1, 1, 32, 128), pages_shape=(9, 16, 8, 128),
              n_pages=3, dtype=torch.float32)
    assert tuning.resolve_paged_splits(8, **kw) == 3
    assert tuning.resolve_paged_splits(None, **kw) == 3


@pytest.mark.parametrize("call", [
    lambda: tuning.resolve_paged_splits(
        16, q_shape=(1, 1, 32, 128), pages_shape=(9, 16, 8, 128),
        n_pages=8, dtype=torch.float32),
    lambda: tuning.resolve_paged_splits(
        0, q_shape=(1, 1, 32, 128), pages_shape=(9, 16, 8, 128),
        n_pages=8, dtype=torch.float32),
    lambda: tuning.resolve_wkv_v_slice(
        128, q_shape=(1, 128, 40, 64), v_head=64, dtype=torch.float32,
        use_u=True),
    lambda: tuning.resolve_wkv_v_slice(
        64, q_shape=(1, 128, 40, 64), v_head=64, dtype=torch.float32,
        use_u=True),
    lambda: tuning.resolve_rmsnorm_threads(
        2048, rows=4, d=4096, dtype=torch.float32),
    lambda: tuning.resolve_rmsnorm_threads(
        1024, rows=4, d=4096, dtype=torch.float32),
    lambda: tuning.resolve_rmsnorm_threads(
        48, rows=4, d=4096, dtype=torch.float32),
], ids=["splits16", "splits0", "vslice128", "vslice64_k64_f32",
        "threads2048", "threads1024", "threads48"])
def test_an_illegal_explicit_value_raises(call):
    with pytest.raises(ValueError):
        call()


def test_an_illegal_tuned_value_raises_and_never_falls_back():
    sig = tuning.rmsnorm_signature(4, 4096, torch.float32)
    tuning.save_entries({tuning.entry_key("rmsnorm_fwd", sig):
                         {"config": {"threads": 2048}}})
    with pytest.raises(ValueError, match="launch bound"):
        tuning.resolve_rmsnorm_threads(None, rows=4, d=4096,
                                       dtype=torch.float32)


def test_a_warm_resolve_builds_no_signature(monkeypatch):
    """The memo: the signature string is built on the first call at a
    shape only; clear_cache() forgets it."""
    built = []
    real = tuning.rmsnorm_signature
    monkeypatch.setattr(tuning, "rmsnorm_signature",
                        lambda *a: built.append(a) or real(*a))
    for _ in range(1000):
        tuning.resolve_rmsnorm_threads(None, rows=128, d=4096,
                                       dtype=torch.float32)
    assert len(built) == 1
    tuning.clear_cache()
    tuning.resolve_rmsnorm_threads(None, rows=128, d=4096,
                                   dtype=torch.float32)
    assert len(built) == 2


# ------------------------------------------------------------ candidates
def test_paged_candidates_put_the_heuristic_first():
    cands, rej, dflt = tune.paged_candidates(4, 32, 8, 128, 41, 16, 10)
    assert cands == [{"splits": s} for s in (4, 1, 2, 8)]
    assert rej == 0 and dflt == {"splits": 4}
    # clamped to the table's pages
    cands, _, dflt = tune.paged_candidates(1, 32, 8, 128, 4, 16, 3)
    assert [c["splits"] for c in cands] == [3, 1, 2] and dflt == \
        {"splits": 3}


@pytest.mark.parametrize("dtype,want,rejected", [
    ("float32", [32, 16], 1),      # V slice 64 at K64 f32: 240,016 B
    ("bfloat16", [32, 16, 64], 0),
])
def test_wkv6_candidates_fit_the_shared_memory(dtype, want, rejected):
    cands, rej, dflt = tune.wkv6_candidates(1, 128, 40, 64, 64, dtype)
    assert [c["v_slice"] for c in cands] == want
    assert rej == rejected and dflt == {"v_slice": want[0]}


@pytest.mark.parametrize("d,first", [(4096, 256), (512, 32), (1600, 128),
                                     (5120, 320)])
def test_rmsnorm_candidates_are_whole_warps_to_512(d, first):
    cands, rej, dflt = tune.rmsnorm_candidates(128, d)
    got = [c["threads"] for c in cands]
    assert got[0] == first == dflt["threads"] and rej == 0
    assert sorted(set(got)) == sorted({first, 32, 64, 128, 256, 512})
    assert all(t % 32 == 0 and 32 <= t <= 512 for t in got)


# ----------------------------------------------------------------- sweep
def _make_fn(**cfg):
    return functools.partial(lambda *a, **k: None, **cfg)


def _timer(times, param):
    def timer(fn, *args, iters=1, warmup=0):
        return times[fn.keywords[param]]
    return timer


SWEEPS = [
    # (candidate values, default, fake times)
    ([256, 32, 64, 128, 512], 256,
     {256: 50.0, 32: 30.0, 64: 20.0, 128: 10.0, 512: 40.0}),
    ([256, 32, 64, 128, 512], 256, dict.fromkeys((256, 32, 64, 128, 512),
                                                 7.0)),
    ([4, 1, 2, 8], 4, {4: 3.0, 1: 9.0, 2: 3.0, 8: 2.9999}),
    ([32, 16], None, {32: 2.0, 16: 1.0}),
    ([16], 16, {16: 5.0}),
]


@pytest.mark.parametrize("values,default,times", SWEEPS)
def test_sweep_is_the_references(values, default, times):
    """The same winner, timings, default_timed and speedup as
    ``repro.bench.tune._sweep`` from the same fake times."""
    cands = [{"p": v} for v in values]
    dflt = None if default is None else {"p": default}
    args = ("k", "sig", cands, 1, dflt, _make_fn, (), _timer(
        times, "p"), 1, 0)
    got, want = tune._sweep(*args), jax_tune._sweep(*args)
    assert got.config == want.config
    assert got.timings == want.timings
    assert got.default_timed == want.default_timed
    assert got.speedup == pytest.approx(want.speedup)
    assert (got.us, got.default_us, got.n_candidates) == \
        (want.us, want.default_us, want.n_candidates)
    assert got.rejected_smem == want.rejected_vmem == 1


def test_sweep_without_candidates_raises():
    with pytest.raises(ValueError, match="no valid launch candidates"):
        tune._sweep("k", "sig", [], 0, None, _make_fn, (),
                    _timer({}, "p"), 1, 0)


def test_tune_rmsnorm_with_a_fake_timer_saves_its_winner(isolated_cache):
    x = torch.zeros((128, 4096))
    sc = torch.ones(4096)
    res = tune.tune_rmsnorm(x, sc, timer=_timer(
        {256: 5.0, 32: 9.0, 64: 4.0, 128: 3.0, 512: 6.0}, "threads"))
    assert res.config == {"threads": 128} and res.default_us == 5.0
    assert res.speedup == pytest.approx(5.0 / 3.0)
    assert res.signature == tuning.rmsnorm_signature(128, 4096,
                                                     torch.float32)
    path = tune.save([res])
    assert path == isolated_cache / "cuda.json"
    assert tuning.resolve_rmsnorm_threads(
        None, rows=128, d=4096, dtype=torch.float32) == 128
    key, entry = res.entry()
    assert key == tuning.entry_key("rmsnorm_fwd", res.signature)
    assert entry["config"] == {"threads": 128}


def test_tune_paged_and_wkv6_with_fake_timers():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((4, 1, 32, 128), np.float32))
    kp = torch.zeros((41, 16, 8, 128))
    bt = torch.arange(1, 41, dtype=torch.int32).reshape(4, 10)
    lens = torch.tensor([160, 159, 155, 145], dtype=torch.int32)
    res = tune.tune_paged_attention(q, kp, kp, bt, lens, timer=_timer(
        {4: 2.0, 1: 3.0, 2: 1.5, 8: 1.5}, "splits"))
    assert res.config == {"splits": 2} and res.n_candidates == 4
    qw = torch.zeros((1, 128, 40, 64))
    res = tune.tune_wkv6(qw, qw, qw, qw - 0.1, torch.zeros(40, 64),
                         timer=_timer({32: 1.0, 16: 2.0}, "v_slice"))
    assert res.config == {"v_slice": 32} and res.rejected_smem == 1
    assert "u=1" in res.signature and "ld=float32" in res.signature


# --------------------------------------------- the wrappers on the CPU
def _paged_inputs():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 64), np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((9, 4, 2, 64),
                                                   np.float32))
              for _ in range(2))
    bt = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    lens = torch.tensor([13, 7], dtype=torch.int32)
    return q, kp, vp, bt, lens


def test_on_the_cpu_a_legal_value_changes_nothing():
    q, kp, vp, bt, lens = _paged_inputs()
    for s in (1, 2, 4, 8):
        assert torch.equal(ops.paged_attention(q, kp, vp, bt, lens,
                                               splits=s),
                           ops.paged_attention(q, kp, vp, bt, lens))
    x, sc = torch.randn(4, 256), torch.rand(256)
    for t in (32, 64, 512):
        assert torch.equal(ops.rmsnorm(x, sc, threads=t),
                           ref.rmsnorm_ref(x, sc))
    qw = torch.randn(1, 20, 2, 16)
    ld = -torch.rand(1, 20, 2, 16)
    for vs in (16, 32, 64):
        o, s = ops.wkv6(qw, qw, qw, ld, v_slice=vs)
        want_o, want_s = ref.wkv6_chunked_ref(qw, qw, qw, ld, None)
        assert torch.equal(o, want_o) and torch.equal(s, want_s)


@pytest.mark.parametrize("call,limit", [
    (lambda: ops.paged_attention(*_paged_inputs(), splits=16), "1 to 8"),
    (lambda: ops.rmsnorm(torch.randn(4, 256), torch.rand(256),
                         threads=2048), "512"),
    (lambda: ops.rmsnorm(torch.randn(4, 256, requires_grad=True),
                         torch.rand(256), threads=100), "whole warps"),
    (lambda: ops.wkv6(*(torch.randn(1, 8, 2, 16),) * 3,
                      -torch.rand(1, 8, 2, 16), v_slice=128), "16, 32, 64"),
], ids=["splits16", "threads2048", "threads100_grad", "vslice128"])
def test_on_the_cpu_an_illegal_value_is_refused(call, limit):
    with pytest.raises(ValueError, match=re.escape(limit)):
        call()


def test_rmsnorm_threads_keeps_its_gradient():
    x = torch.randn(4, 64, requires_grad=True)
    sc = torch.rand(64, requires_grad=True)
    g = torch.autograd.grad(ops.rmsnorm(x, sc, threads=64).sum(), (x, sc))
    want = torch.autograd.grad(ops.rmsnorm(x, sc).sum(), (x, sc))
    assert all(torch.equal(a, b) for a, b in zip(g, want))


# ------------------------------------------------------------ the suite
TUNE_SCENARIOS = ["tune/paged_attention", "tune/wkv6", "tune/rmsnorm"]


def test_tune_scenarios_run_only_with_tune(capsys):
    from repro_torch.bench.__main__ import main
    assert main(["--device", "cpu", "--list"]) == 0
    out = capsys.readouterr().out
    assert not any(s in out for s in TUNE_SCENARIOS)
    assert main(["--device", "cpu", "--tune", "--list"]) == 0
    listed = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert listed == TUNE_SCENARIOS
    assert main(["--device", "cpu", "--tune", "--only", "kernels/rmsnorm",
                 "--list"]) == 0
    assert capsys.readouterr().out.split()[0] == "kernels/rmsnorm"


def test_tune_workloads_are_not_run_on_the_cpu(isolated_cache):
    from repro_torch.bench import (BenchRunner, ListSink, env_fingerprint,
                                   select)
    from repro_torch.bench.__main__ import with_device
    sink = ListSink()
    summary = BenchRunner(sinks=[sink], env=env_fingerprint("cpu")).run(
        [with_device(s, "cpu") for s in select(only="tune/")])
    assert not summary.failures
    names = [r.name for r in sink.records]
    assert names == [
        "tune/paged_attention/ref_B4_P64_ps16_H4_KV2_D64",
        "tune/paged_attention/path_B4_ctx160_ps16_H32_KV8_D128",
        "tune/wkv6/ref_B1_T256_H2_K64", "tune/wkv6/path_B1_T128_H40_K64_V64_u",
        "tune/rmsnorm/ref_r4096_d512", "tune/rmsnorm/ref_r1024_d256",
        "tune/rmsnorm/path_r128_d4096"]
    assert all("not_run" in r.derived and r.us_per_call == 0.0
               for r in sink.records)
    assert not (isolated_cache / "cuda.json").exists()


def test_the_suite_uses_the_references_shapes():
    import benchmarks.bench_tune as jax_suite
    from repro_torch.bench.suites import tune as suite
    assert suite.PAGED_SHAPES["ref"] == jax_suite._PAGED_SHAPES[0]
    assert suite.NORM_SHAPES["ref"] == jax_suite._NORM_SHAPES
    label, spec = suite.WKV_SHAPES["ref"]
    jlabel, jspec = jax_suite._WKV_SHAPES[0]
    assert label == jlabel and {k: spec[k] for k in jspec} == jspec
