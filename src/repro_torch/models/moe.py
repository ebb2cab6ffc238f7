"""Mixture-of-Experts FFN with sort-based (dropping) token dispatch.

The PyTorch counterpart of ``repro/models/moe.py``'s one-device path
(``_moe_ffn_dense``): tokens are sorted by expert id and gathered into
(E, C, d) capacity buffers, so dispatch costs gathers and scatters, not
a one-hot product. Expert weights are stacked (E, d, f), the reference's
layout. The three expert products are plain batched matrix products
(``torch.bmm``); the reference runs them outside any Pallas kernel too.

The same tokens are dropped as in the reference: a stable sort by
expert (``jnp.argsort`` is stable), each token's position in its
expert's segment from a left ``searchsorted``, and tokens past the
capacity sent to an overflow row ``E * C`` that is written and then
discarded. The combine adds each kept (token, k) row back onto zeros:
with top-k <= 2 a token receives at most two adds, and a + b == b + a,
so the order of the scatter-add cannot change a bit.

:func:`moe_ffn_shardmap` is the reference's expert-parallel dispatch
over a mesh (``Runtime.moe_shardmap``): each rank holds its data shard's
tokens and its ``model`` shard of the experts. Its capacity is budgeted
per data shard, so it drops other tokens than the one-device path; it is
held to the reference's shard_map version, not to this dense path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import apply_mlp_tp, mlp_init, normal
from repro_torch.parallel import collectives as coll


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    e = cfg.moe
    d, f = cfg.d_model, e.expert_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"router": normal(gen, (d, e.num_experts), s_in, torch.float32),
         "w_in": normal(gen, (e.num_experts, d, f), s_in, dtype),
         "w_gate": normal(gen, (e.num_experts, d, f), s_in, dtype),
         "w_out": normal(gen, (e.num_experts, f, d), s_out, dtype)}
    if e.dense_residual_ff:
        p["dense"] = mlp_init(gen, d, e.dense_residual_ff, cfg.activation,
                              dtype)
    return p


def capacity(tokens: int, e: MoEConfig) -> int:
    """Slots per expert: tokens * top_k / experts * capacity_factor,
    rounded up to a multiple of 8 and at least 8, as the reference sizes
    them (for the TPU's lanes)."""
    c = int(math.ceil(tokens * e.top_k / e.num_experts * e.capacity_factor))
    return max(8, -(-c // 8) * 8)


def _experts(buf, p, activation: str):
    """The expert FFN on capacity buffers (E, C, d) -> (E, C, d)."""
    h = torch.bmm(buf, p["w_in"])
    if activation == "swiglu":
        h = F.silu(torch.bmm(buf, p["w_gate"])) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, p["w_out"])


def _route(xf, router, K: int, dtype):
    """Router probabilities (T, E) f32, and the top-K experts (T, K) with
    their renormalised gates (in ``dtype``)."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals.to(dtype), expert_idx


def moe_ffn_shardmap(p, x, cfg: ModelConfig, rt):
    """Expert-parallel MoE over ``rt.mesh`` (the reference's shard_map
    dispatch). This rank -- data shard i, model shard j -- holds data shard
    i's tokens x (B_loc, S, d) and experts ``j*E_loc ..`` of ``p``
    ((E_loc, d, f) after any ZeRO-3 gather), so dispatch is a LOCAL masked
    gather of the tokens routed to its experts, capacity ``C_loc``
    budgeted per data shard. The tokens and gates enter through the copy
    region over ``rt.ep_axes`` and the outputs leave summed over them;
    the per-expert load is summed over the batch axes and gathered over
    the EP axes to (E,). The router's statistics (its probability mass and
    top-1 share) are averaged over the batch axes, so ``aux_loss`` is the
    reference's, computed on every token."""
    e = cfg.moe
    mesh = rt.mesh
    B, S, d = x.shape
    T_loc = B * S
    E, K = e.num_experts, e.top_k
    dp = tuple(rt.mesh_batch_axes)
    ep = tuple(rt.ep_axes)
    C_loc = max(8, -(-int(math.ceil(T_loc * K / E * e.capacity_factor))
                     // 8) * 8)
    E_loc = p["w_in"].shape[0]
    if E_loc * coll.axis_size(mesh, ep) != E:
        raise ValueError(f"{E} experts do not shard over the EP axes {ep} "
                         f"as {E_loc} a rank")
    lo = coll.axis_index(mesh, ep) * E_loc

    xf = x.reshape(T_loc, d)
    probs, gates, expert_idx = _route(xf, p["router"], K, x.dtype)
    xl = coll.copy_to(xf, mesh, ep)
    gates = coll.copy_to(gates, mesh, ep)
    flat_e = expert_idx.reshape(-1)
    flat_g = gates.reshape(-1)
    tok = torch.arange(T_loc, device=x.device).repeat_interleave(K)
    rel = torch.where((flat_e >= lo) & (flat_e < lo + E_loc), flat_e - lo,
                      E_loc)
    order = torch.argsort(rel, stable=True)
    se, sg, st = rel[order], flat_g[order], tok[order]
    seg_start = torch.searchsorted(
        se, torch.arange(E_loc, device=x.device, dtype=se.dtype),
        side="left")
    pos = (torch.arange(T_loc * K, device=x.device)
           - seg_start[torch.clamp(se, max=E_loc - 1)])
    keep = (se < E_loc) & (pos < C_loc)
    dest = torch.where(keep, se * C_loc + pos, E_loc * C_loc)
    rows_in = torch.where(keep[:, None], xl[st], 0)
    buf = x.new_zeros((E_loc * C_loc + 1, d)).index_put((dest,), rows_in)
    ob = _experts(buf[:E_loc * C_loc].reshape(E_loc, C_loc, d), p,
                  cfg.activation).reshape(E_loc * C_loc, d)
    y_rows = ob[torch.where(keep, dest, 0)] * (sg * keep)[:, None].to(
        x.dtype)
    y = x.new_zeros((T_loc, d)).index_add(0, st, y_rows)
    y = coll.reduce_from(y, mesh, ep).reshape(B, S, d)
    load = torch.zeros(E_loc, dtype=torch.float32, device=x.device)
    load = load.index_add(0, torch.clamp(se, max=E_loc - 1), keep.float())
    if dp:
        load = coll.all_reduce(load, mesh, dp)
    load = coll.all_gather(load, mesh, ep)
    if e.dense_residual_ff:
        y = y + apply_mlp_tp(p["dense"], x, cfg.activation,
                             e.dense_residual_ff, mesh)
    me = coll.mean_over(probs.mean(0), mesh, dp)
    ce = coll.mean_over(F.one_hot(expert_idx[:, 0], E).float().mean(0),
                        mesh, dp)
    aux_loss = E * torch.sum(me * ce) * e.router_aux_weight
    return y, {"aux_loss": aux_loss, "expert_load": load,
               "capacity": C_loc}


def moe_ffn(p, x, cfg: ModelConfig, rt=None):
    """The expert-parallel dispatch where ``rt.moe_shardmap``, else the
    one-device path below."""
    if rt is not None and rt.moe_shardmap:
        return moe_ffn_shardmap(p, x, cfg, rt)
    return _moe_ffn_dense(p, x, cfg, None if rt is None else rt.mesh)


def _moe_ffn_dense(p, x, cfg: ModelConfig, mesh=None):
    """x: (B, S, d) -> (out, aux). aux: ``aux_loss`` (the Switch
    load-balance loss times ``router_aux_weight``, f32 scalar),
    ``expert_load`` ((E,) f32: kept (token, k) pairs per expert) and
    ``capacity`` (int)."""
    e = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    E, K = e.num_experts, e.top_k
    C = capacity(T, e)

    probs, gate_vals, expert_idx = _route(xf, p["router"], K,
                                          torch.float32)

    # ---- flatten (token, k) pairs and sort by expert ----------------------
    flat_expert = expert_idx.reshape(-1)                         # (T*K,)
    flat_gate = gate_vals.reshape(-1)
    flat_token = torch.arange(T, device=x.device).repeat_interleave(K)
    order = torch.argsort(flat_expert, stable=True)
    se, sg, st = flat_expert[order], flat_gate[order], flat_token[order]
    # position within the expert's segment
    seg_start = torch.searchsorted(
        se, torch.arange(E, device=x.device, dtype=se.dtype), side="left")
    pos = torch.arange(T * K, device=x.device) - seg_start[se]
    keep = pos < C
    dest = torch.where(keep, se * C + pos, E * C)                # overflow row

    # ---- gather into capacity buffers -------------------------------------
    rows_in = torch.where(keep[:, None], xf[st], 0)
    buf = x.new_zeros((E * C + 1, d)).index_put((dest,), rows_in)
    buf = buf[:E * C].reshape(E, C, d)

    # ---- expert FFN ---------------------------------------------------------
    out_buf = _experts(buf, p, cfg.activation).reshape(E * C, d)

    # ---- combine back -------------------------------------------------------
    rows = torch.where(keep, dest, 0)
    y_rows = out_buf[rows] * (sg * keep)[:, None].to(x.dtype)
    y = x.new_zeros((T, d)).index_add(0, st, y_rows).reshape(B, S, d)
    if e.dense_residual_ff:
        y = y + apply_mlp_tp(p["dense"], x, cfg.activation,
                             e.dense_residual_ff, mesh)

    # ---- aux: load-balance loss (Switch) + per-expert load -----------------
    me = probs.mean(0)                                           # prob mass
    ce = F.one_hot(expert_idx[:, 0], E).float().mean(0)          # routed share
    aux_loss = E * torch.sum(me * ce) * e.router_aux_weight
    expert_load = torch.zeros(E, dtype=torch.float32,
                              device=x.device).index_add(0, se, keep.float())
    return y, {"aux_loss": aux_loss, "expert_load": expert_load,
               "capacity": C}
