"""Card-only tests of the port: each hand-written kernel against its plain
PyTorch version on a CUDA device, over the shapes the CPU cannot reach
(ragged sequence edges, sliding windows, GQA groups, null-padded and
all-null block tables), plus the reduced model and engines through the
kernels, and one training backward through them.

The CPU tests (``tests/test_torch_*.py``) hold the plain versions to the
JAX package; these hold the kernels to the plain versions. They import
only the port — the machine with the card has no JAX — and skip, inside
each test, where there is no card. Run them on the card with
``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

F32, BF16 = torch.float32, torch.bfloat16
# tolerances of tests/test_kernels.py::_tol: the kernels sum in f32 in
# another order than the plain versions, which in bf16 also round the
# scores and the softmax weights to bf16
TOL = {F32: 5e-4, BF16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(device=dev, dtype=dtype)


def _close(out, want, dtype):
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.detach().float().cpu().numpy(),
                               want.detach().float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("sq,sk,hq,hkv,d,causal,window", [
    (128, 128, 32, 8, 128, True, 0),     # the serving path's prefill
    (77, 77, 4, 4, 64, True, 0),         # ragged edge inside one tile
    (300, 300, 8, 2, 128, True, 0),      # several tiles, ragged
    (200, 200, 8, 2, 32, True, 96),      # sliding window skips tiles
    (130, 130, 8, 1, 16, False, 0),      # non-causal, MQA
    (100, 100, 4, 2, 64, False, 96),     # one-sided window, non-causal
    (50, 77, 8, 2, 160, True, 0),        # Sq < Sk
    (1100, 1100, 25, 5, 64, True, 1024),  # hymba-1.5b's long prefill
])
def test_flash_kernel_matches_plain(dev, dtype, sq, sk, hq, hkv, d, causal,
                                    window):
    rng = np.random.default_rng(sq * 7 + sk + hq + d)
    q = _rand(rng, (2, sq, hq, d), dtype, dev)
    k = _rand(rng, (2, sk, hkv, d), dtype, dev)
    v = _rand(rng, (2, sk, hkv, d), dtype, dev)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _close(out, want, dtype)


def test_forward_lse_at_the_training_shape(dev):
    """B2 in f32 at S4096 D128 causal (the training shape, fewer heads):
    lse within 1e-5 absolute of the plain forward's, the output within
    TOL."""
    from repro_torch.kernels.flash_attention import flash_attention_lse_cuda
    rng = np.random.default_rng(4096)
    q = _rand(rng, (1, 4096, 8, 128), F32, dev)
    k, v = (_rand(rng, (1, 4096, 2, 128), F32, dev) for _ in range(2))
    o, lse = flash_attention_lse_cuda(q, k, v, causal=True, window=0)
    o_want, lse_want = ref.flash_attention_lse_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert float((lse - lse_want).abs().max()) <= 1e-5
    _close(o, o_want, F32)


def _ulp_err():
    """Phase 2's bf16 measure, ``chip_smoke._ulp_err``, and its gate."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._ulp_err, mod.ULP_TOL


@pytest.mark.parametrize("s,hq,hkv,d,window", [
    (128, 32, 8, 128, 0),        # granite-3-8b's serving prefill
    (2048, 32, 8, 128, 0),
    (1100, 25, 5, 64, 1024),     # hymba-1.5b's long prefill, past its window
])
def test_forward_bf16_within_a_unit_of_rounding(dev, s, hq, hkv, d, window):
    """K1 in bf16 within one unit of bf16 rounding of the plain version
    computed in f32 from the same bf16 inputs (phase 2's gate)."""
    ulp_err, tol = _ulp_err()
    rng = np.random.default_rng(s + d)
    q = _rand(rng, (1, s, hq, d), BF16, dev)
    k, v = (_rand(rng, (1, s, hkv, d), BF16, dev) for _ in range(2))
    kw = dict(causal=True, window=window)
    out = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    assert ulp_err(out, want) <= tol


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_forward_is_deterministic(dev, dtype):
    """K1 and B2 use no atomics: two launches on the same inputs give the
    same bits."""
    from repro_torch.kernels.flash_attention import flash_attention_lse_cuda
    rng = np.random.default_rng(7)
    q = _rand(rng, (2, 1000, 16, 128), dtype, dev)
    k, v = (_rand(rng, (2, 1000, 2, 128), dtype, dev) for _ in range(2))
    first = flash_attention_lse_cuda(q, k, v, causal=True, window=0)
    second = flash_attention_lse_cuda(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_refuses_unaligned_rows(dev):
    """K1-B4 copy rows 16 bytes at a time: ops.flash_attention refuses q,
    k, v (and the backward its dO) that do not start on a 16-byte
    boundary, with no fallback and no launch."""
    flat = torch.zeros(8 * 4 * 64 + 1, device=dev)
    bad = flat[1:].view(1, 8, 4, 64)              # contiguous, offset 4 bytes
    good = torch.zeros(1, 8, 4, 64, device=dev)
    ops.reset_launches()
    for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="16-byte boundary"):
            ops.flash_attention(*args)
    leaves = [t.clone().requires_grad_() for t in (good, good, good)]
    o = ops.flash_attention(*leaves)
    with pytest.raises(ValueError, match="16-byte boundary"):
        torch.autograd.grad(o, leaves, bad)
    assert ops.LAUNCHES["flash_attention"] == 0
    assert ops.LAUNCHES["flash_attention_dq"] == 0


def _paged_inputs(rng, dtype, dev, hq, hkv, d, ps, layout):
    """q, pools, block table and lengths of one K2 case. ``mixed``: 5 rows
    of a 12-page table, null-padded past each length, the last row all
    null pages (a retired lane). ``b1_wide``: one row of 160 tokens in a
    256-page table (the engine's table is cache_span / page_size wide).
    ``b4_ctx4096``: 4 rows near 4096 tokens. ``sparse``: 4 rows of 1, 16,
    17 and 33 tokens in a 64-page table, so most of each row's splits
    hold no page."""
    B, npag, lengths = {
        "mixed": (5, 12, [1, ps + 3, 5 * ps, 12 * ps, 7]),
        "b1_wide": (1, 256, [160]),
        "b4_ctx4096": (4, 4096 // ps, [4096, 4095, 4091, 4081]),
        "sparse": (4, 64, [1, 16, 17, 33]),
    }[layout]
    P = B * npag + 1
    q = _rand(rng, (B, 1, hq, d), dtype, dev)
    kp = _rand(rng, (P, ps, hkv, d), dtype, dev)
    vp = _rand(rng, (P, ps, hkv, d), dtype, dev)
    perm = rng.permutation(np.arange(1, P)).reshape(B, npag)
    lengths = np.array(lengths, np.int32)
    btab = np.zeros((B, npag), np.int32)
    live_rows = B - 1 if layout == "mixed" else B
    for b in range(live_rows):              # null-padded past the length
        live = -(-int(lengths[b]) // ps)
        btab[b, :live] = perm[b, :live]
    return (q, kp, vp, torch.from_numpy(btab).to(dev),
            torch.from_numpy(lengths).to(dev))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("hq,hkv,d,ps,layout", [
    (32, 8, 128, 16, "mixed"), (4, 4, 32, 4, "mixed"),
    (8, 2, 64, 16, "mixed"), (8, 1, 128, 32, "mixed"),
    (32, 8, 128, 16, "b1_wide"), (32, 8, 128, 16, "b4_ctx4096"),
    (32, 8, 128, 16, "sparse")])
def test_paged_kernel_matches_plain(dev, dtype, hq, hkv, d, ps, layout):
    """K2 against its plain version: ragged lengths, null-padded tables and
    a retired all-null row (``mixed``), a table far wider than its live
    pages, a long context, and rows whose splits are mostly empty."""
    rng = np.random.default_rng(hq + d + ps)
    q, kp, vp, bt, ln = _paged_inputs(rng, dtype, dev, hq, hkv, d, ps, layout)
    before = ops.LAUNCHES["paged_attention"]
    out = ops.paged_attention(q, kp, vp, bt, ln)
    assert ops.LAUNCHES["paged_attention"] == before + 1
    _close(out, ref.paged_decode_attention_ref(q, kp, vp, bt, ln), dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("layout", ["b1_wide", "b4_ctx4096"])
def test_paged_kernel_is_deterministic(dev, dtype, layout):
    """The splits combine in a fixed order: two calls give the same bits."""
    rng = np.random.default_rng(3)
    args = _paged_inputs(rng, dtype, dev, 32, 8, 128, 16, layout)
    a = ops.paged_attention(*args)
    b = ops.paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("rows,d,offset", [
    (1, 64, 0), (7, 100, 0), (512, 4096, 0), (1100, 1600, 0),
    # decode: one row per lane
    (1, 4096, 0), (4, 4096, 0), (8, 4096, 0),
    (1, 1600, 0), (4, 1600, 0), (8, 1600, 0),
    # one row for each of the H100's 132 SMs, and one more
    (132, 4096, 0), (133, 1600, 0),
    # a training microbatch; rows longer than a block holds in registers
    (4096, 4096, 0), (3, 40000, 0),
    # rows not on 16-byte boundaries: d not a multiple of the vector, or x
    # starting one element past one
    (4, 100, 0), (300, 100, 0), (4, 4097, 0), (300, 4097, 0),
    (4, 4096, 1), (300, 4096, 1)])
def test_rmsnorm_kernel_matches_plain(dev, dtype, rows, d, offset):
    rng = np.random.default_rng(rows + d + offset)
    flat = _rand(rng, (rows * d + offset,), dtype, dev)
    x = flat[offset:].view(rows, d)
    scale = _rand(rng, (d,), F32, dev)
    before = ops.LAUNCHES["rmsnorm"]
    out = ops.rmsnorm(x, scale)
    assert ops.LAUNCHES["rmsnorm"] == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    _close(out, ref.rmsnorm_ref(x, scale), dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("rows,d", [(4, 4096), (4, 1600), (4096, 4096),
                                    (300, 4097)])
def test_rmsnorm_kernel_is_deterministic(dev, dtype, rows, d):
    """A block sums its row in a fixed order (thread chains, xor shuffles,
    warps in order): two calls give the same bits."""
    rng = np.random.default_rng(rows * d)
    x = _rand(rng, (rows, d), dtype, dev)
    scale = _rand(rng, (d,), F32, dev)
    a = ops.rmsnorm(x, scale)
    b = ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(1, 8, 4, 48, device=dev)            # head dim 48
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim"):   # B2-B4's path
        ops.flash_attention(q.requires_grad_(), q, q)
    # B3 and B4 copy 16 bytes at a time: a tensor that does not start on a
    # 16-byte boundary is refused at launch
    from repro_torch.kernels.flash_attention import (
        flash_attention_dkv_cuda, flash_attention_dq_cuda)
    flat = torch.zeros(8 * 4 * 64 + 1, device=dev)
    qm = flat[1:].view(1, 8, 4, 64)
    rows = torch.zeros(1, 4, 8, device=dev)
    for launch in (flash_attention_dq_cuda, flash_attention_dkv_cuda):
        with pytest.raises(RuntimeError, match="misaligned"):
            launch(qm, qm, qm, qm, rows, rows, causal=True, window=0)
    qp = torch.zeros(1, 1, 4, 30, device=dev)           # head dim 30
    pool = torch.zeros(3, 4, 4, 30, device=dev)
    bt = torch.ones(1, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.paged_attention(qp, pool, pool, bt, bt[:, 0])
    x = torch.zeros(4, 8, device=dev).t()               # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        ops.rmsnorm(x, torch.ones(4, device=dev))


def test_reduced_engines_agree_through_the_kernels(dev):
    """Continuous (K1 prefill) and paged (K2 decode) engines give the same
    greedy tokens on the card, and each kernel was launched."""
    from repro_torch.data.pipeline import synth_requests
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving import SimClock

    kw = dict(layers=2, d_model=128, vocab=512, d_ff=256)
    cont, cfg = build_engine("granite-3-8b", batch=4, prompt_len=40,
                             max_new_tokens=24, reduce_kw=kw,
                             clock=SimClock(), device=dev)
    paged, _ = build_engine("granite-3-8b", batch=4, prompt_len=40,
                            max_new_tokens=24, scheduler="paged",
                            page_size=16, prefill_chunk_tokens=16,
                            reduce_kw=kw, clock=SimClock(), device=dev)
    reqs = synth_requests(cfg, 6, 40, max_new_tokens=(3, 24))
    ops.reset_launches()
    rc = cont.run(reqs)
    assert ops.LAUNCHES["flash_attention"] > 0
    rp = paged.run(reqs)
    assert ops.LAUNCHES["paged_attention"] > 0 and ops.LAUNCHES["rmsnorm"] > 0
    toks_c = {m.rid: m.tokens.tolist() for m in rc.metrics}
    toks_p = {m.rid: m.tokens.tolist() for m in rp.metrics}
    assert toks_c == toks_p


# ----------------------------------------------------------- training
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("sq,sk,hq,hkv,d,causal,window", [
    (256, 256, 8, 2, 128, True, 0),      # tileable, GQA
    (200, 200, 4, 1, 64, True, 96),      # ragged, MQA, sliding window
    (130, 130, 4, 4, 32, False, 0),      # ragged, non-causal
])
def test_training_kernels_match_plain(dev, dtype, sq, sk, hq, hkv, d, causal,
                                      window):
    """B2 (forward with lse), B3 (dq) and B4 (dk, dv) against their plain
    versions, through the autograd Function of ops.flash_attention."""
    rng = np.random.default_rng(sq + hq + d + int(causal))
    kw = dict(causal=causal, window=window)
    q = _rand(rng, (2, sq, hq, d), dtype, dev).requires_grad_()
    k = _rand(rng, (2, sk, hkv, d), dtype, dev).requires_grad_()
    v = _rand(rng, (2, sk, hkv, d), dtype, dev).requires_grad_()
    do = _rand(rng, (2, sq, hq, d), dtype, dev)
    ops.reset_launches()
    o = ops.flash_attention(q, k, v, **kw)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    assert {n: ops.LAUNCHES[n] for n in ("flash_attention",
            "flash_attention_lse", "flash_attention_dq",
            "flash_attention_dkv")} == {"flash_attention": 0,
                                        "flash_attention_lse": 1,
                                        "flash_attention_dq": 1,
                                        "flash_attention_dkv": 1}
    with torch.no_grad():
        o_want, lse_want = ref.flash_attention_lse_ref(q, k, v, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o_want, lse_want, do, **kw)
    _close(o, o_want, dtype)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == dtype
        _close(got, w, dtype)
    from repro_torch.kernels.flash_attention import flash_attention_lse_cuda
    _, lse = flash_attention_lse_cuda(q.detach(), k.detach(), v.detach(), **kw)
    _close(lse, lse_want, F32)


def _bwd_inputs(dtype, dev, sq, sk, hq, hkv, d, causal, window, seed=0):
    """q, k, v, do and the plain forward's lse and delta for B3 and B4."""
    rng = np.random.default_rng(seed + sq + 3 * sk + hq + d + int(causal))
    q, do = (_rand(rng, (2, sq, hq, d), dtype, dev) for _ in range(2))
    k, v = (_rand(rng, (2, sk, hkv, d), dtype, dev) for _ in range(2))
    o, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    return q, k, v, do, lse, ref.attention_delta(o, do)


# every head dim of the dispatch, GQA, MQA, ragged edges, sliding windows,
# non-causal and Sq != Sk
BWD_CASES = [
    (256, 256, 8, 2, True, 0),       # tileable, GQA
    (200, 200, 4, 1, True, 96),      # ragged, MQA, sliding window
    (130, 130, 4, 4, False, 0),      # ragged, non-causal
    (100, 77, 6, 2, False, 40),      # Sq > Sk, one-sided window, non-causal
]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 160])
@pytest.mark.parametrize("sq,sk,hq,hkv,causal,window", BWD_CASES)
def test_backward_kernels_match_plain(dev, dtype, d, sq, sk, hq, hkv, causal,
                                      window):
    """B3 (dq) and B4 (dk, dv) against their plain versions on the same
    q, k, v, do, lse and delta."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_dkv_cuda, flash_attention_dq_cuda)
    kw = dict(causal=causal, window=window)
    args = _bwd_inputs(dtype, dev, sq, sk, hq, hkv, d, causal, window)
    dq = flash_attention_dq_cuda(*args, **kw)
    dk, dv = flash_attention_dkv_cuda(*args, **kw)
    want = (ref.flash_attention_dq_ref(*args, **kw),
            *ref.flash_attention_dkv_ref(*args, **kw))
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == w.shape
        _close(got, w, dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_backward_kernels_are_deterministic(dev, dtype):
    """B3 and B4 use no atomics and B4 sums its GQA group in a fixed order:
    two runs on the same inputs give the same bits."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_dkv_cuda, flash_attention_dq_cuda)
    kw = dict(causal=True, window=0)
    args = _bwd_inputs(dtype, dev, 1000, 1000, 16, 2, 128, True, 0)
    first = (flash_attention_dq_cuda(*args, **kw),
             *flash_attention_dkv_cuda(*args, **kw))
    second = (flash_attention_dq_cuda(*args, **kw),
              *flash_attention_dkv_cuda(*args, **kw))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_reduced_loss_grads_through_the_kernels_match_dense(dev):
    """One loss.backward() of reduced granite-3-8b through B2-B4 and K3
    gives the gradients of the plain attention path."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import Runtime, build

    dev = torch.device("cuda", 0)          # the generator's device, resolved
    cfg = reduced(get_arch("granite-3-8b"), layers=2, d_model=256)
    batch = SyntheticLM(cfg, 2, 96, mean_doc_len=32, device="cuda").batch_at(0)
    grads = {}
    for backend in ("kernel", "dense"):
        model = build(cfg, Runtime(attention_backend=backend), device=dev)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_()
        ops.reset_launches()
        loss, _ = model.loss(params, batch)
        loss.backward()
        grads[backend] = (float(loss), [t.grad for t in leaves])
        if backend == "kernel":
            assert ops.LAUNCHES["flash_attention_lse"] == 4   # 2 layers, remat
            assert ops.LAUNCHES["flash_attention_dq"] == 2
            assert ops.LAUNCHES["flash_attention_dkv"] == 2
            assert ops.LAUNCHES["rmsnorm"] == 9               # 5 + 4 recomputed
    (lk, gk), (ld, gd) = grads["kernel"], grads["dense"]
    np.testing.assert_allclose(lk, ld, rtol=1e-5)
    for a, b in zip(gk, gd):
        _close(a, b, F32)


# -------------------------------------------------------------- wkv6 (B6)
def _wkv6_inputs(rng, B, T, H, K, V, dtype, dev, lo, hi, use_u):
    q, k = (_rand(rng, (B, T, H, K), dtype, dev) for _ in range(2))
    v = _rand(rng, (B, T, H, V), dtype, dev)
    ld = torch.from_numpy(-rng.uniform(lo, hi, (B, T, H, K))
                          .astype(np.float32)).to(dev)
    u = (_rand(rng, (H, K), F32, dev) * 0.5) if use_u else None
    return q, k, v, ld, u


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("T", [128, 125, 300])
@pytest.mark.parametrize("regime", [(0.001, 0.2), (0.5, 1.0), (2.0, 12.0),
                                    (6.0, 12.0)])
@pytest.mark.parametrize("mode,K,V", [("rwkv6", 64, 64), ("ssd", 16, 64),
                                      ("rwkv6", 32, 40), ("ssd", 64, 16)])
def test_wkv6_kernel_matches_plain(dev, dtype, T, regime, mode, K, V):
    """B6 against its plain version: both modes, decays from mild (every
    sub-block rescaled on the tensor cores) to 6-12 a token (every 16-row
    sub-block spans more than 88, where a factor e^-p would overflow f32;
    the plain version takes its per-pair fallback in every chunk past
    0.5 a token), ragged last chunks, K != V and V not a multiple of the
    kernel's 16-column slices. Error over the plain result's max
    magnitude."""
    rng = np.random.default_rng(T + K + V + int(regime[1]))
    q, k, v, ld, u = _wkv6_inputs(rng, 2, T, 3, K, V, dtype, dev, *regime,
                                  mode == "rwkv6")
    before = ops.LAUNCHES["wkv6"]
    o, s = ops.wkv6(q, k, v, ld, u)
    assert ops.LAUNCHES["wkv6"] == before + 1
    assert o.dtype == dtype and s.dtype == F32
    want_o, want_s = ref.wkv6_chunked_ref(q, k, v, ld, u)
    torch.cuda.synchronize()
    for got, want in ((o, want_o), (s, want_s)):
        err = float((got.float() - want.float()).abs().max())
        assert err <= TOL[dtype] * float(want.float().abs().max())


def test_wkv6_kernel_reads_strided_inputs(dev):
    """SSD's per-head decay as a broadcast view (stride 0 along K), q from
    a transposed tensor, an initial state folded in, bf16 q with f32
    ld."""
    rng = np.random.default_rng(0)
    B, T, H, K, V = 2, 100, 5, 16, 64
    q = _rand(rng, (B, H, T, K), BF16, dev).transpose(1, 2)
    k = _rand(rng, (B, T, H, K), BF16, dev)
    v = _rand(rng, (B, T, H, V), BF16, dev)
    ld = torch.from_numpy(-rng.uniform(0.3, 0.9, (B, T, H, 1))
                          .astype(np.float32)).to(dev).expand(B, T, H, K)
    s0 = _rand(rng, (B, H, K, V), F32, dev)
    o, s = ops.wkv6(q, k, v, ld, None, s0)
    want_o, want_s = ref.wkv6_chunked_ref(q.contiguous(), k, v,
                                          ld.contiguous(), None, s0)
    torch.cuda.synchronize()
    for got, want in ((o, want_o), (s, want_s)):
        err = float((got.float() - want.float()).abs().max())
        assert err <= TOL[BF16] * float(want.float().abs().max())


def test_wkv6_refuses_a_gradient_on_the_card(dev):
    """B6 has no backward (nor has the reference): a CUDA input that
    requires grad raises instead of returning an output without a
    grad_fn; without grad recording it runs."""
    rng = np.random.default_rng(1)
    q, k, v, ld, u = _wkv6_inputs(rng, 1, 64, 2, 16, 16, F32, dev, 0.01,
                                  0.1, True)
    for leaf in (q, ld, u):
        leaf.requires_grad_()
        with pytest.raises(ValueError, match="no backward kernel"):
            ops.wkv6(q, k, v, ld, u)
        with torch.no_grad():
            ops.wkv6(q, k, v, ld, u)
        leaf.requires_grad_(False)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_reduced_ssm_engines_agree_through_the_kernels(dev, arch):
    """Static and continuous engines give the same greedy tokens on the
    card through B6 (32-token and 70-token prompts: hymba's reduced
    window of 64 wraps), and B6 launched once per layer and prefill."""
    from repro_torch.data.pipeline import synth_requests
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving import SimClock

    kw = dict(layers=2, d_model=128, vocab=512, d_ff=256)
    toks = {}
    for sched in ("static", "continuous"):
        eng, cfg = build_engine(arch, batch=2, prompt_len=70,
                                max_new_tokens=24, scheduler=sched,
                                reduce_kw=kw, clock=SimClock(), device=dev)
        reqs = (synth_requests(cfg, 2, 70, max_new_tokens=(3, 24))
                + synth_requests(cfg, 2, 32, max_new_tokens=6, seed=1))
        for r in reqs[2:]:
            r.rid += 100
        ops.reset_launches()
        rep = eng.run(reqs)
        assert ops.LAUNCHES["wkv6"] == 2 * rep.prefills
        toks[sched] = {m.rid: m.tokens.tolist() for m in rep.metrics}
    assert toks["static"] == toks["continuous"]


# ----------------------------------------- launch parameters (tuning)
def _candidate_plans():
    """Every plan the lint makes at its canonical shapes, with each
    launch parameter's candidates at those shapes too."""
    from repro_torch.analysis import kernel_lint
    from repro_torch.bench import tune
    plans = kernel_lint.all_plans()
    for dims in kernel_lint.CANONICAL_DIMS["paged_attention_fwd"]:
        cands = tune.paged_candidates(dims["B"], dims["Hq"], dims["Hkv"],
                                      dims["D"], dims["P"], dims["ps"],
                                      dims["npag"], dims["dtype"])[0]
        for cfg in cands:
            plans += kernel_lint.plans("paged_attention_fwd", dims, cfg)
    for dims in kernel_lint.CANONICAL_DIMS["wkv6_fwd"]:
        cands = tune.wkv6_candidates(dims["B"], dims["T"], dims["H"],
                                     dims["K"], dims["V"], dims["dtype"])[0]
        for cfg in cands:
            plans += kernel_lint.plans("wkv6_fwd", dims, cfg)
    for dims in kernel_lint.CANONICAL_DIMS["rmsnorm_fwd"]:
        for cfg in tune.rmsnorm_candidates(dims["rows"], dims["d"],
                                           dims["dtype"])[0]:
            plans += kernel_lint.plans("rmsnorm_fwd", dims, cfg)
    return plans


def test_each_plan_query_is_the_lints_plan(dev):
    """The C plan query (computed by the functions the launcher calls)
    equals the lint's plan field by field, for every kernel at the
    canonical shapes and every candidate; the heuristic (0) equals its
    Python mirror."""
    from repro_torch.analysis import kernel_lint
    from repro_torch.kernels import _build
    for p in _candidate_plans():
        assert _build.plan(p.query, *p.query_args) == p.launch(), p
    for p in kernel_lint.all_plans():
        if p.query in ("paged_attention", "wkv6", "rmsnorm"):
            heuristic = _build.plan(p.query, *p.query_args[:-1], 0)
            assert heuristic == p.launch(), p


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 8])
def test_paged_kernel_at_each_split_count(dev, dtype, splits):
    """K2 at every split count, granite's decode (B4 ctx160 Hq32 Hkv8
    D128, 10 pages) and a wide table whose live pages leave splits empty:
    held to the plain version, and two calls give the same bits."""
    for layout in ("mixed", "b1_wide"):
        rng = np.random.default_rng(splits)
        args = _paged_inputs(rng, dtype, dev, 32, 8, 128, 16, layout)
        before = ops.LAUNCHES["paged_attention"]
        a = ops.paged_attention(*args, splits=splits)
        b = ops.paged_attention(*args, splits=splits)
        assert ops.LAUNCHES["paged_attention"] == before + 2
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        _close(a, ref.paged_decode_attention_ref(*args), dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("v_slice", [16, 32, 64])
@pytest.mark.parametrize("mode,K,V", [("rwkv6", 64, 64), ("ssd", 16, 64),
                                      ("rwkv6", 32, 48)])
def test_wkv6_kernel_at_each_v_slice(dev, dtype, v_slice, mode, K, V):
    """B6 at every V slice whose layout fits: held to the plain version
    (relative to its largest magnitude), deterministic; a slice that does
    not fit raises."""
    from repro_torch.kernels import tuning
    rng = np.random.default_rng(v_slice + K)
    q, k = (_rand(rng, (1, 130, 4, K), dtype, dev) for _ in range(2))
    v = _rand(rng, (1, 130, 4, V), dtype, dev)
    ld = -torch.exp(_rand(rng, (1, 130, 4, K), F32, dev) - 3.0)
    u = 0.1 * _rand(rng, (4, K), F32, dev) if mode == "rwkv6" else None
    try:
        tuning.check_v_slice(v_slice, K, q.element_size(), 4)
    except ValueError:
        with pytest.raises(ValueError, match="opt-in limit"):
            ops.wkv6(q, k, v, ld, u, v_slice=v_slice)
        return
    o1, s1 = ops.wkv6(q, k, v, ld, u, v_slice=v_slice)
    o2, s2 = ops.wkv6(q, k, v, ld, u, v_slice=v_slice)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(s1, s2)
    for got, want in zip((o1, s1), ref.wkv6_chunked_ref(q, k, v, ld, u)):
        err = float((got.float() - want.float()).abs().max())
        assert err <= TOL[dtype] * max(float(want.float().abs().max()),
                                       1e-30)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("threads", [32, 64, 128, 256, 512, 96])
@pytest.mark.parametrize("rows,d", [(128, 4096), (4, 1600), (7, 100),
                                    (3, 40000)])
def test_rmsnorm_kernel_at_each_thread_count(dev, dtype, threads, rows, d):
    """K3 at thread counts below and above the heuristic's pick: the
    kernel loops over what its registers do not hold, so every count
    computes the whole row (40,000 elements on 32 threads too)."""
    rng = np.random.default_rng(threads + d)
    x = _rand(rng, (rows, d), dtype, dev)
    scale = _rand(rng, (d,), F32, dev)
    a = ops.rmsnorm(x, scale, threads=threads)
    b = ops.rmsnorm(x, scale, threads=threads)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _close(a, ref.rmsnorm_ref(x, scale), dtype)


def test_illegal_launch_parameters_raise_on_the_card(dev):
    rng = np.random.default_rng(0)
    args = _paged_inputs(rng, F32, dev, 32, 8, 128, 16, "mixed")
    with pytest.raises(ValueError, match="cluster"):
        ops.paged_attention(*args, splits=16)
    x = torch.ones(4, 64, device=dev)
    with pytest.raises(ValueError, match="launch bound"):
        ops.rmsnorm(x, torch.ones(64, device=dev), threads=1024)
    q = torch.ones(1, 8, 2, 64, device=dev)
    with pytest.raises(ValueError, match="V slices"):
        ops.wkv6(q, q, q, -q, v_slice=128)
    # the C entry points refuse them too, whatever the caller passes
    from repro_torch.kernels import _build
    with pytest.raises(RuntimeError):
        _build.plan("paged_attention", 4, 41, 16, 32, 8, 128, 10, 0, 9)
    with pytest.raises(RuntimeError):
        _build.plan("rmsnorm", 4, 64, 0, 1, 48)
    with pytest.raises(RuntimeError):
        _build.plan("wkv6", 1, 8, 2, 64, 64, 0, 0, 128)


def test_the_step_audit_is_clean_on_the_card(dev):
    from repro_torch.analysis import graph_audit
    findings = graph_audit.audit_all(device=dev)
    assert findings == [], [str(f) for f in findings]


def test_a_transfer_inside_a_step_is_flagged_on_the_card(dev):
    from repro_torch.analysis import graph_audit

    def step(x):
        return x.cpu().sum() + x.sum().to("cpu")

    def read(x):
        return x * len(x.tolist())

    for fn in (step, read):
        rules = {f.rule for f in graph_audit.audit_function(
            "planted", fn, torch.ones(4, device=dev))}
        assert rules == {"RG005"}, fn
