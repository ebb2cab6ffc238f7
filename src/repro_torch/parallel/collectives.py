"""Collective building blocks over ``torch.distributed``: the counterpart
of ``repro/parallel/collectives.py``, plus the autograd-aware regions that
tensor parallelism and ZeRO-3 need (JAX's SPMD partitioner inserts those
collectives by itself).

Every function takes the :class:`~torch.distributed.device_mesh.DeviceMesh`
and the mesh axis (or tuple of axes) it runs over. A mesh of ``None``
(or axes the mesh lacks) is one device, where every collective is the
identity; over axes of one rank they still run (a copy), so that a mesh
of one card goes through them. Over a tuple of axes they run over the
flattened group, whose rank order puts the first axis outermost, as JAX
lays such axes out.

* :func:`decode_partials` and :func:`combine_partials` -- flash-decoding
  over a KV cache whose SEQUENCE dim is sharded: each shard attends to its
  slice, and the (max, sum-exp, weighted-value) triples are combined by a
  MAX and two SUM reductions, so the cache is never gathered.
  :func:`partitioned_decode_attention` is the two over a mesh axis.
* :func:`compressed_psum_grads` -- int8 error-feedback gradient
  all-reduce (all-to-all of quantised chunks, exact sum, re-quantise,
  all-gather).
* :func:`copy_to` / :func:`reduce_from` -- the entry and exit of a
  tensor-parallel region (Megatron's f and g); :func:`gather_data` --
  ZeRO-3's weight gather (all-gather forward, reduce-scatter backward);
  :func:`gather_model` -- a model-sharded weight gathered for a computation
  every model rank repeats (all-gather forward, this rank's block of the
  gradient backward); :func:`mean_over` -- a mean over data shards whose
  backward passes the gradient through unscaled (the step averages the
  gradients over the data shards afterwards).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels.ref import NEG_INF

Axes = Union[str, Sequence[str]]
_FLAT: dict = {}


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def group_of(mesh, axes: Axes):
    """The process group of ``axes`` (flattened for several), or None
    for one device."""
    axes = _axes(axes) if mesh is None else tuple(
        a for a in _axes(axes) if a in mesh.mesh_dim_names)
    if mesh is None or not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _FLAT:
        _FLAT[key] = mesh[axes]._flatten("_".join(axes))
    return _FLAT[key].get_group()


def axis_size(mesh, axes: Axes) -> int:
    """The ranks over ``axes``; an axis the mesh lacks counts as one."""
    n = 1
    for a in _axes(axes):
        if mesh is not None and a in mesh.mesh_dim_names:
            n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axis_index(mesh, axes: Axes) -> int:
    """This rank's index over ``axes``, the first axis outermost."""
    idx = 0
    for a in _axes(axes):
        if mesh is not None and a in mesh.mesh_dim_names:
            idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) \
                + mesh.get_local_rank(a)
    return idx


# -------------------------------------------------------- raw collectives
# newer torch renames the single-tensor forms (the old names warn)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _runs(mesh, axes: Axes) -> bool:
    return group_of(mesh, axes) is not None


def all_reduce(x: torch.Tensor, mesh, axes: Axes,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x`` (``x`` itself is left alone)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if _runs(mesh, axes):
        dist.all_reduce(out, op=op, group=group_of(mesh, axes))
    return out


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int = 0):
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    if not _runs(mesh, axes):
        return x
    n = axis_size(mesh, axes)
    xm = x.detach().movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0], *xm.shape[1:]))
    _ALL_GATHER(out, xm, group=group_of(mesh, axes))
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, mesh, axes: Axes, dim: int = 0):
    """The sum over ranks of ``x``, this rank's block along ``dim``."""
    if not _runs(mesh, axes):
        return x
    n = axis_size(mesh, axes)
    xm = x.detach().movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // n, *xm.shape[1:]))
    _REDUCE_SCATTER(out, xm, group=group_of(mesh, axes))
    return out.movedim(0, dim)


# ------------------------------------------------------- autograd regions
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, \
            None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.idx = axis_index(mesh, axes)
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.idx * ctx.size, ctx.size), None, None, \
            None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes) / axis_size(mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(x, mesh, axes: Axes = "model"):
    """Enter a tensor-parallel region: identity forward, all-reduce of the
    gradient backward (each rank's part of it comes from its shards)."""
    return _CopyTo.apply(x, mesh, axes) if _runs(mesh, axes) else x


def reduce_from(x, mesh, axes: Axes = "model"):
    """Leave a tensor-parallel region: all-reduce forward (the sum of the
    ranks' partial products), identity backward."""
    return _ReduceFrom.apply(x, mesh, axes) if _runs(mesh, axes) else x


def gather_data(x, mesh, axes: Axes = "data", dim: int = 0):
    """ZeRO-3's weight gather: all-gather along ``dim`` forward,
    reduce-scatter (sum) of the gradient backward."""
    return _GatherData.apply(x, mesh, axes, dim) if _runs(mesh, axes) else x


def gather_model(x, mesh, axes: Axes = "model", dim: int = 0):
    """A model-sharded weight gathered for a computation every model rank
    repeats: all-gather forward; backward, this rank's block of the
    (replicated) gradient."""
    return _GatherModel.apply(x, mesh, axes, dim) if _runs(mesh, axes) \
        else x


def mean_over(x, mesh, axes: Axes):
    """The mean of ``x`` over the ranks of ``axes`` forward; the gradient
    passes through unscaled backward (each rank's share of it is scaled
    when the step averages the gradients over the data shards)."""
    return _MeanOver.apply(x, mesh, axes) if _runs(mesh, axes) else x


# ------------------------------------------------------ partitioned decode
def decode_partials(q, k_local, v_local, cache_len, offset: int = 0):
    """One query token against a slice of the cache holding global
    positions ``offset .. offset + S_loc - 1``: q (B,1,Hq,D), k_local and
    v_local (B,S_loc,Hkv,D); cache_len a scalar or (B,) per-row valid
    lengths, in global positions. Returns (m, l, o): the row max and the
    sum of exp(s - m) over the slice's valid positions, (B,Hkv,g) f32,
    and the unnormalised exp-weighted values (B,Hkv,g,D) in v's dtype."""
    B, _, Hq, D = q.shape
    S_loc, Hkv = k_local.shape[1], k_local.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_local) / math.sqrt(D)
    s = s.float()
    gpos = offset + torch.arange(S_loc, device=q.device)
    if isinstance(cache_len, torch.Tensor):
        cache_len = cache_len.reshape(-1, 1).to(q.device)
    mask = gpos[None, :] < cache_len
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_local.dtype), v_local)
    return m, l, o


def combine_partials(parts, mesh=None, axes: Axes = "model"):
    """The attention output (B,1,Hq,D) from partials of disjoint slices
    of the cache: ``parts`` is one (m, l, o) triple, or a list of them
    (slices held in this process), and ``mesh``/``axes`` the ranks that
    hold the other slices. MAX-reduces m, then SUM-reduces l.corr and
    o.corr, corr = exp(m - max)."""
    if isinstance(parts, tuple):
        parts = [parts]
    m_glob = parts[0][0]
    for m, _, _ in parts[1:]:
        m_glob = torch.maximum(m_glob, m)
    m_glob = all_reduce(m_glob, mesh, axes, dist.ReduceOp.MAX)
    l_sum, o_sum = None, None
    for m, l, o in parts:
        corr = torch.exp(m - m_glob)
        lc, oc = l * corr, o * corr[..., None].to(o.dtype)
        l_sum = lc if l_sum is None else l_sum + lc
        o_sum = oc if o_sum is None else o_sum + oc
    l_sum = all_reduce(l_sum, mesh, axes)
    o_sum = all_reduce(o_sum, mesh, axes)
    o = o_sum / torch.clamp(l_sum[..., None], min=1e-30).to(o_sum.dtype)
    B, Hkv, g, D = o.shape
    return o.reshape(B, 1, Hkv * g, D)


def partitioned_decode_attention(q, k_local, v_local, cache_len, mesh,
                                 seq_axis: Axes = "model"):
    """Decode attention over a cache whose sequence dim is sharded over
    ``seq_axis``: this rank holds positions ``i * S_loc ..`` of its batch
    rows (i its index over the axis). q (B,1,Hq,D) with all heads, the
    same on every rank of the axis; cache_len a scalar or (B,) per-row
    lengths. Returns (B,1,Hq,D) on every rank of the axis."""
    offset = axis_index(mesh, seq_axis) * k_local.shape[1]
    return combine_partials(
        decode_partials(q, k_local, v_local, cache_len, offset), mesh,
        seq_axis)


# ----------------------------------------------------- int8 all-reduce
def int8_quantize(x) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _q8_rows(x):
    scale = torch.clamp(x.abs().amax(dim=-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


@torch.no_grad()
def compressed_psum_grads(grads, residuals, mesh,
                          data_axes: Axes = ("data",)):
    """Error-feedback int8 all-reduce over the data axes: (1) quantise
    local chunks and all-to-all them, so rank i owns chunk i of every
    rank; (2) sum exactly, re-quantise the owned chunk and all-gather it.
    Both phases move int8, and the local quantisation error is fed back
    into the next step's gradient. ``grads`` and ``residuals`` are trees
    alike (residuals f32, flat, zeros at the start). Returns
    (reduced_grads, new_residuals)."""
    n = axis_size(mesh, data_axes)
    group = group_of(mesh, data_axes)

    def reduce_leaf(g, r):
        flat = g.reshape(-1).float() + r
        N = flat.shape[0]
        chunks = F.pad(flat, (0, (-N) % n)).reshape(n, -1)
        q, scale = _q8_rows(chunks)
        qs, ss = torch.empty_like(q), torch.empty_like(scale)
        if mesh is not None:
            dist.all_to_all_single(qs, q, group=group)
            dist.all_to_all_single(ss, scale, group=group)
        else:
            qs.copy_(q)
            ss.copy_(scale)
        summed = (qs.float() * ss[:, None]).sum(0)               # (c,)
        q2, s2 = _q8_rows(summed)
        out_q = all_gather(q2, mesh, data_axes)                   # (n*c,)
        out_s = all_gather(s2[None], mesh, data_axes)             # (n,)
        out = (out_q.reshape(n, -1).float()
               * out_s[:, None]).reshape(-1)[:N]
        err1 = (chunks - q.float() * scale[:, None]).reshape(-1)[:N]
        err2 = all_gather(summed - q2.float() * s2, mesh, data_axes)[:N]
        return out.reshape(g.shape).to(g.dtype), err1 + err2 / n

    def walk(g, r):
        if isinstance(g, dict):
            pairs = {k: walk(g[k], r[k]) for k in g}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        return reduce_leaf(g, r)

    return walk(grads, residuals)
