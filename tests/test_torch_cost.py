"""The port's cost counter (``repro_torch.core.cost``) against the JAX
package's optimized-HLO reader, and the hand-written kernels' own counts
(``repro_torch.kernels.work``).

* A reduced granite forward through the port's ``dense`` attention path
  counts the same matrix products as ``analyze_hlo`` reads in the JAX
  forward (``attention_backend="dense"``) of the same config and batch,
  product for product. XLA rewrote none of them here.
* ``loss.backward()`` without remat counts 3x the forward's products; with
  remat the recomputed forward is counted too (all but each layer's last
  product, which the non-reentrant checkpoint does not recompute).
* On the kernel path each wrapper's own count replaces the aten operations
  of its plain version, and equals what the card path reports for the
  same shapes: the same function of the shapes, on tensors of any device.
"""
import re
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from repro.configs import get_arch, reduced
from repro.core.hlo_analysis import HloAnalyzer, _TRIP_RE, analyze_hlo
from repro.models import Runtime as JaxRuntime
from repro.models import build as jax_build
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_arch as torch_get_arch
from repro_torch.configs import reduced as torch_reduced
from repro_torch.core.cost import count_cost, op_cost, top_consumers
from repro_torch.kernels import ops, work
from repro_torch.models import Runtime, build

torch.set_num_threads(2)
B, S = 2, 16


def _tokens(vocab):
    toks = np.random.default_rng(0).integers(1, vocab, (B, S), dtype=np.int32)
    return toks


def _torch_model(backend, remat=False):
    cfg = torch_reduced(torch_get_arch("granite-3-8b"))
    model = build(cfg, Runtime(attention_backend=backend, remat=remat),
                  device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg.vocab_size)).long()
    return model, params, {"tokens": toks, "labels": toks}


def _hlo_products(text):
    """[(flops of one execution, executions)] of every dot in the module,
    each loop body's dots times its trip count."""
    a = HloAnalyzer(text)
    out = []

    def walk(comp, mult):
        for i in a.comps.get(comp, []):
            if i.opcode == "while":
                m = _TRIP_RE.search(i.attrs)
                trip = float(m.group(1)) if m else 1.0
                for b in (a._called(i.attrs, "body")
                          + a._called(i.attrs, "condition")):
                    walk(b, mult * trip)
            elif i.opcode in ("fusion", "call"):
                for b in (a._called(i.attrs, "calls")
                          + a._called(i.attrs, "to_apply")):
                    walk(b, mult)
            elif i.opcode == "dot":
                out.append((a._dot_flops(comp, i), mult))
    walk(a.entry, 1.0)
    return out


class _Products(TorchDispatchMode):
    """Each matrix product's flops, as ``op_cost`` counts them."""

    def __init__(self):
        super().__init__()
        self.flops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        _, flops, _, dot = op_cost(func, args, kwargs, out)
        if dot:
            self.flops.append(flops)
        return out


def test_forward_products_equal_the_hlo_reader():
    jcfg = reduced(get_arch("granite-3-8b"))
    jm = jax_build(jcfg, JaxRuntime(attention_backend="dense"),
                   param_dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    toks = jnp.asarray(_tokens(jcfg.vocab_size))
    text = jax.jit(lambda p, b: jm.loss(p, b)[0]).lower(
        jp, {"tokens": toks, "labels": toks}).compile().as_text()
    model, params, batch = _torch_model("dense")
    with torch.no_grad():
        _, cost = count_cost(model.loss, params, batch)
        with _Products() as products:
            model.loss(params, batch)
    assert cost.dot_flops == analyze_hlo(text).dot_flops
    want = Counter()
    for flops, n in _hlo_products(text):
        want[flops] += int(n)
    assert Counter(products.flops) == want
    assert sum(products.flops) == cost.dot_flops


@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_backward_counts_three_forwards_of_products(backend):
    model, params, batch = _torch_model(backend)
    with torch.no_grad():
        _, fwd = count_cost(model.loss, params, batch)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]

    def step():
        loss = model.loss(params, batch)[0]
        loss.backward()
        return loss
    _, both = count_cost(step)
    assert both.dot_flops == 3 * fwd.dot_flops
    assert all(t.grad is not None for t in leaves)


def test_remat_recompute_is_counted():
    """torch.utils.checkpoint's recomputation is counted as the HLO counts
    remat: the layers' forward products once more, B2 and K3 launched
    again in the recompute."""
    L = 2
    counts = {}
    for remat in (False, True):
        model, params, batch = _torch_model("kernel", remat=remat)
        leaves = [t.requires_grad_() for t in tree_leaves(params)]
        counts[remat] = count_cost(lambda: torch.autograd.grad(
            model.loss(params, batch)[0], leaves))[1]
    plain, remat = counts[False], counts[True]
    assert plain.kernels["flash_attention_lse"]["calls"] == L
    assert remat.kernels["flash_attention_lse"]["calls"] == 2 * L
    assert remat.kernels["flash_attention_dq"]["calls"] == L
    assert remat.kernels["rmsnorm"]["calls"] == \
        plain.kernels["rmsnorm"]["calls"] + 2 * L
    # every product of each layer again but its last, the MLP's down
    # projection: checkpoint stops recomputing once it has rebuilt what
    # the backward needs, and nothing needs that product's output
    cfg = model.cfg
    d, hd = cfg.d_model, cfg.resolved_head_dim
    recomputed = 2 * B * S * L * (
        d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
        + cfg.num_heads * hd * d + 2 * d * cfg.d_ff)
    assert remat.dot_flops - plain.dot_flops == recomputed


def test_kernel_path_counts_the_kernels_not_their_plain_versions():
    dense, params, batch = _torch_model("dense")
    kernel = build(dense.cfg, Runtime(attention_backend="kernel",
                                      remat=False), device="cpu")
    with torch.no_grad():
        d = count_cost(dense.loss, params, batch)[1]
        k = count_cost(kernel.loss, params, batch)[1]
    cfg = dense.cfg
    L, Hq, D = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    # the dense path's QK^T and PV over the whole (S, S) score matrix
    assert d.dot_flops - k.dot_flops == L * 2 * 2 * B * Hq * S * S * D
    assert "aten.bmm" not in k.flops_by_op
    assert k.kernels["flash_attention"]["calls"] == L
    assert k.kernels["flash_attention"]["flops"] == \
        L * 4 * D * B * Hq * S * (S + 1) // 2
    # the norms run K3 on both paths: none of its plain ops is counted
    assert "aten.rsqrt" not in k.flops_by_op
    assert k.kernels["rmsnorm"] == d.kernels["rmsnorm"]
    assert ("kernel:flash_attention" in
            [key for _, key in top_consumers(k, n=50)])


def _meta(t):
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device="meta")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_each_wrapper_reports_its_kernels_own_work(causal, window):
    """Under the counter each wrapper reports one call of its kernel with
    the work of kernels/work.py, the function the card path evaluates,
    and no aten operation of its plain version."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    q, k, v = rnd(1, 12, 4, 16), rnd(1, 12, 2, 16), rnd(1, 12, 2, 16)
    kw = dict(causal=causal, window=window)
    with torch.no_grad():
        cost = count_cost(ops.flash_attention, q, k, v, **kw)[1]
    assert cost.kernels == {"flash_attention": {
        "calls": 1, **dict(zip(("flops", "bytes"),
                               work.flash_forward(_meta(q), _meta(k),
                                                  **kw)))}}
    assert set(cost.flops_by_op) == {"kernel:flash_attention"}
    # differentiated: B2 forward, then B3 and B4 and the plain delta
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    do = rnd(*q.shape)
    cost = count_cost(lambda: torch.autograd.grad(
        ops.flash_attention(*leaves, **kw), leaves, do))[1]
    want = {"flash_attention_lse": work.flash_forward(q, k, lse=True, **kw),
            "flash_attention_dq": work.flash_dq(q, k, **kw),
            "flash_attention_dkv": work.flash_dkv(q, k, **kw)}
    assert {n: (c["calls"], c["flops"], c["bytes"])
            for n, c in cost.kernels.items()} == \
        {n: (1, *w) for n, w in want.items()}
    # delta = rowsum(dO * O) is plain PyTorch on both paths, counted so
    assert {key for key in cost.flops_by_op
            if not key.startswith("kernel:")} <= {"aten.mul", "aten.sum"}


def test_paged_rmsnorm_and_wkv6_report_their_work():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 1, 4, 16, generator=g)
    kp, vp = torch.randn(9, 4, 2, 16, generator=g), \
        torch.randn(9, 4, 2, 16, generator=g)
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 0]], dtype=torch.int32)
    lens = torch.tensor([13, 9], dtype=torch.int32)
    x, scale = torch.randn(5, 7, 32, generator=g), torch.randn(32, generator=g)
    qw, kw_ = torch.randn(1, 70, 2, 8, generator=g), \
        torch.randn(1, 70, 2, 8, generator=g)
    vw = torch.randn(1, 70, 2, 16, generator=g)
    ld = -torch.rand(1, 70, 2, 8, generator=g)
    u = torch.randn(2, 8, generator=g)
    with torch.no_grad():
        cases = {
            "paged_attention": (lambda: ops.paged_attention(q, kp, vp, bt,
                                                            lens),
                                work.paged_decode(_meta(q), _meta(kp), lens,
                                                  4)),
            "rmsnorm": (lambda: ops.rmsnorm(x, scale),
                        work.rmsnorm(35, 32, 4)),
            "wkv6": (lambda: ops.wkv6(qw, kw_, vw, ld, u),
                     work.wkv6(qw, vw, ld, u)),
        }
        for name, (call, want) in cases.items():
            cost = count_cost(call)[1]
            assert cost.kernels == {name: {"calls": 1, "flops": want.flops,
                                           "bytes": want.bytes}}, name
            assert set(cost.flops_by_op) | set(cost.bytes_by_op) == \
                {f"kernel:{name}"}, name
    # paged: 4 multiply-adds per live token, q head and dim; 7 live pages
    assert cases["paged_attention"][1].flops == 4 * 4 * 16 * 22
    assert cases["paged_attention"][1].bytes == \
        4 * (2 * 22 * 2 * 16 + 2 * 2 * 4 * 16) + 4 * (7 + 2)


def test_attention_pairs_match_the_mask():
    for sq, sk, causal, window in [(7, 7, True, 0), (7, 7, True, 3),
                                   (5, 9, True, 2), (9, 5, True, 0),
                                   (6, 6, False, 0), (6, 6, False, 4)]:
        qp, kp = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
        keep = torch.ones(sq, sk, dtype=torch.bool)
        if causal:
            keep &= qp >= kp
        if window:
            keep &= qp - kp < window
        assert work.attention_pairs(sq, sk, causal, window) == \
            int(keep.sum())


def test_the_counter_counts_ops_by_kind():
    x = torch.randn(8, 16)
    w = torch.randn(16, 32)
    b = torch.randn(32)
    _, c = count_cost(lambda: (torch.addmm(b, x, w).exp().sum(-1),
                               x.t().contiguous(), x.expand(4, 8, 16) + 1,
                               x.to(torch.float64)))
    assert c.dot_flops == 2 * 8 * 16 * 32
    assert c.flops_by_op["aten.exp"] == 8 * 32          # one per output
    assert c.flops_by_op["aten.sum"] == 8 * 32          # one per input
    assert "aten.clone" not in c.flops_by_op            # a copy: bytes only
    assert c.bytes_by_op["aten.clone"] == 2 * 8 * 16 * 4
    assert "aten._to_copy" not in c.flops_by_op
    assert "aten.t" not in c.bytes_by_op                # a view: nothing
    # a broadcast input counts the storage it spans
    assert c.bytes_by_op["aten.add"] == 4 * (8 * 16 + 4 * 8 * 16)
    assert c.flops == pytest.approx(sum(c.flops_by_op.values()))
    assert c.collectives == [] and c.collective_ici_bytes == 0
    assert re.match(r"aten\.", top_consumers(c, 1, by="bytes")[0][1])
