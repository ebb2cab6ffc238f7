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

The reference's expert-parallel ``moe_ffn_shardmap`` waits for the
port's ``parallel/`` (ROADMAP.md A.7); on one device the reference takes
this dense path as well.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import apply_mlp, mlp_init, normal


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


def moe_ffn(p, x, cfg: ModelConfig):
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

    logits = xf.float() @ p["router"]                            # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)         # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

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
    h = torch.bmm(buf, p["w_in"])
    if cfg.activation == "swiglu":
        h = F.silu(torch.bmm(buf, p["w_gate"])) * h
    else:
        h = F.gelu(h, approximate="tanh")
    out_buf = torch.bmm(h, p["w_out"]).reshape(E * C, d)

    # ---- combine back -------------------------------------------------------
    rows = torch.where(keep, dest, 0)
    y_rows = out_buf[rows] * (sg * keep)[:, None].to(x.dtype)
    y = x.new_zeros((T, d)).index_add(0, st, y_rows).reshape(B, S, d)
    if e.dense_residual_ff:
        y = y + apply_mlp(p["dense"], x, cfg.activation)

    # ---- aux: load-balance loss (Switch) + per-expert load -----------------
    me = probs.mean(0)                                           # prob mass
    ce = F.one_hot(expert_idx[:, 0], E).float().mean(0)          # routed share
    aux_loss = E * torch.sum(me * ce) * e.router_aux_weight
    expert_load = torch.zeros(E, dtype=torch.float32,
                              device=x.device).index_add(0, se, keep.float())
    return y, {"aux_loss": aux_loss, "expert_load": expert_load,
               "capacity": C}
