"""Layer stacks of every family: dense, moe (an MoE FFN in place of the
MLP, arctic's with a dense residual MLP beside it), vlm (M-RoPE), audio
(whisper's bidirectional encoder and its decoder's cross attention), ssm
(rwkv6) and hybrid (attention + SSD heads, sliding window): layer init,
the training forward (``stack_apply``, with remat), prefill, decode and
the paged-KV serving triple (full-attention decoder-only models, as in
the reference).

The PyTorch counterpart of ``repro/models/transformer.py``. Parameters
keep the JAX layout: a leading stacked-layer axis on every leaf, and the
JAX ``lax.scan`` over that axis becomes a Python loop. Caches and paged
pools are updated IN PLACE (the JAX functions return new arrays); each
function that writes says so, and returns the same cache objects it was
given.

Under a mesh (``Runtime.mesh``, a ``DeviceMesh`` with ``data`` and
``model`` axes) each rank holds its shards of the parameters
(:func:`repro_torch.parallel.sharding.param_pspecs`) and computes on its
rows of the batch: each layer first puts its weights together where it
needs them (:func:`repro_torch.parallel.layout.local_layer`), attention
and the MLP run tensor-parallel on their ``model`` shards (entering
through the copy region, leaving through the reduce region), and the
MoE runs expert-parallel (``moe_shardmap``). The decode caches follow
``cache_pspecs``: all key/value heads, the batch over the data axes and,
under ``decode_partitioned``, the sequence over ``model``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._tree import layer_at, tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core.spans import span
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp_tp, apply_mrope,
                                       apply_norm, apply_rope, mlp_init,
                                       norm_init)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import layout


@dataclass(frozen=True)
class Runtime:
    """Execution knobs threaded through the apply functions.

    ``attention_backend="kernel"`` sends full-sequence attention through
    the flash kernels (K1 in one-shot prefill; B2 forward with B3 and B4
    backward in training) and paged decode through kernel K2 (each takes
    its plain version on CPU tensors); ``"dense"`` uses the plain PyTorch
    attention for all of them. RMSNorm always goes through kernel K3 on
    CUDA tensors.

    ``ssm_backend`` selects the linear attention of the ssm and hybrid
    families' full-sequence forward (:func:`repro_torch.models.ssm.
    linear_attention`): ``"kernel"`` runs kernel B6 (forward only),
    ``"chunked"`` the plain chunk-parallel form (``ssm_factored``: its
    two-level variant), ``"recurrent"`` the per-token recurrence. Decode
    always runs the one-step recurrence, as in the reference.

    ``remat`` recomputes each layer (or block of ``layers_per_block``
    layers, when that divides the depth) in the backward of
    :func:`stack_apply` instead of keeping its activations, as the JAX
    package's ``jax.checkpoint`` over its layer scan.

    The mesh fields, as the reference's: ``decode_partitioned`` (decode
    attention over a sequence-sharded cache, combined across ``model``),
    ``mesh_batch_axes`` (the axes the batch shards over) and ``dp_size``
    (their product), ``moe_shardmap`` (expert-parallel MoE dispatch) over
    ``ep_axes``. ``mesh``: the ``DeviceMesh`` whose groups the
    collectives run over (None: one device); ``param_specs``: the spec
    tree of the parameters' shards, which says what each layer gathers."""
    attention_backend: str = "kernel"
    ssm_backend: str = "kernel"
    ssm_factored: bool = False
    remat: bool = True
    layers_per_block: int = 1
    decode_partitioned: bool = False
    mesh_batch_axes: tuple = ()
    dp_size: int = 1
    moe_shardmap: bool = False
    ep_axes: tuple = ("model",)
    mesh: object = field(default=None, compare=False)
    param_specs: object = field(default=None, compare=False)


def _rope_q_k(cfg: ModelConfig, q, k, positions):
    """Rotary embedding of q and k at ``positions``: (B or 1, S) for RoPE;
    for M-RoPE its three (t, h, w) streams, (B or 1, 3, S). Sinusoidal
    positions are added at the embedding; 'none' rotates nothing."""
    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
    return q, k


def _streams(cfg: ModelConfig, pos):
    """Token positions (R, S) as :func:`_rope_q_k` takes them: M-RoPE's
    three streams all equal to them (text tokens), (R, 3, S)."""
    if cfg.rope == "mrope":
        return pos[:, None].expand(pos.shape[0], 3, pos.shape[1])
    return pos


def _ffn(p, x, cfg: ModelConfig, rt: Runtime):
    """The MLP, or the MoE FFN, on x's second pre-norm, added to x.
    Returns (x, aux): the MoE's ``aux_loss``, ``expert_load`` and
    ``capacity``, or {} for an MLP."""
    with span("repro_torch.model.mlp"):
        h_in = apply_norm(p["norm2"], x, cfg.norm)
        if cfg.moe is not None:
            h, aux = moe_mod.moe_ffn(p["moe"], h_in, cfg, rt)
            return x + h, aux
        return x + apply_mlp_tp(p["mlp"], h_in, cfg.activation, cfg.d_ff,
                                rt.mesh), {}


# ============================================================ mesh helpers
def local_layer(p, cfg: ModelConfig, rt: Runtime, stack: str = "layers"):
    """Layer ``p`` (this rank's shards) as it computes on them: the
    weights of ``stack`` gathered where the layer needs them whole
    (:func:`repro_torch.parallel.layout.local_layer`); ``p`` itself on
    one device."""
    if rt.mesh is None or rt.param_specs is None:
        return p
    specs = layout.layer_specs(rt.param_specs[stack])
    return layout.local_layer(p, specs, cfg, rt.mesh)


def _attn_tp(pa, cfg: ModelConfig) -> bool:
    """Attention runs tensor-parallel: the projections hold a share of
    the heads."""
    return pa["wq"].shape[-1] != cfg.num_heads * cfg.resolved_head_dim


def _heads_all(t, rt: Runtime, tp: bool):
    """(B,S,H_loc,D) -> every rank's heads (B,S,H,D): the cache layout of
    ``cache_pspecs`` keeps all key/value heads."""
    return coll.all_gather(t, rt.mesh, "model", dim=2) if tp else t


def _head_slice(t, rt: Runtime, n: int):
    """This rank's ``n`` heads of (B,S,H,D)."""
    i = coll.axis_index(rt.mesh, "model")
    return t[:, :, i * n:(i + 1) * n]


def _seq_shard(t, rt: Runtime):
    """This rank's block of the sequence dim (1) over ``model``: the
    cache layout under ``decode_partitioned``."""
    m = coll.axis_size(rt.mesh, "model")
    if t.shape[1] % m:
        raise ValueError(f"a cache of {t.shape[1]} positions does not "
                         f"shard over {m} model ranks")
    n = t.shape[1] // m
    i = coll.axis_index(rt.mesh, "model")
    return t[:, i * n:(i + 1) * n].contiguous()


# ===================================================================== init
def layer_init(gen: torch.Generator, cfg: ModelConfig, dtype, *,
               cross: bool = False) -> dict:
    """One layer's parameters; ``cross``: with the cross attention of an
    encoder-decoder model's decoder layer (whisper)."""
    dev = gen.device
    p = {"norm1": norm_init(cfg.d_model, cfg.norm, dev),
         "norm2": norm_init(cfg.d_model, cfg.norm, dev)}
    if cfg.family == "ssm":                       # rwkv6 block
        p["time_mix"] = ssm_mod.rwkv6_init(gen, cfg, dtype)
        p["channel_mix"] = ssm_mod.rwkv6_channel_mix_init(gen, cfg, dtype)
        return p
    p["attn"] = attn_mod.attn_init(gen, cfg, dtype)
    if cfg.family == "hybrid":
        p["ssm"] = ssm_mod.ssd_init(gen, cfg, dtype)
    if cross:
        p["norm_cross"] = norm_init(cfg.d_model, cfg.norm, dev)
        p["cross_attn"] = attn_mod.attn_init(gen, cfg, dtype)
    if cfg.moe is not None:
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                            dtype)
    return p


def stack_init(gen: torch.Generator, cfg: ModelConfig, num_layers: int,
               dtype, *, cross: bool = False) -> dict:
    """Stacked (L, ...) layer parameters, drawn one layer at a time into
    preallocated tensors, so peak memory is the stack plus one layer (one
    layer alone is stacked as a view of itself: a full-width arctic layer
    is 56 GB in f32)."""
    first = layer_init(gen, cfg, dtype, cross=cross)
    if num_layers == 1:
        return tree_map(lambda a: a[None], first)
    stacked = tree_map(lambda a: a.new_empty((num_layers, *a.shape)), first)
    for i in range(num_layers):
        layer = first if i == 0 else layer_init(gen, cfg, dtype,
                                                cross=cross)
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, layer)
    return stacked


def num_layers_of(stacked) -> int:
    return tree_leaves(stacked)[0].shape[0]


# ================================================================= forward
def _ring_from_prefill(k, span: int):
    """The last ``span`` prefill K/V rows in ring-buffer slot order (the
    token at position p lives at slot p % span), zero-padded to span."""
    B, S = k.shape[:2]
    take = min(S, span)
    ring = k.new_zeros((B, span, *k.shape[2:]))
    slots = (torch.arange(take, device=k.device) + (S - take)) % span
    ring[:, slots] = k[:, S - take:]
    return ring


def layer_apply(p, x, cfg: ModelConfig, rt: Runtime, positions,
                enc_out=None, *, causal: bool = True,
                return_cache: bool = False, cache_span: int = 0):
    """Full-sequence layer forward. Returns (x, aux, cache_entry): aux is
    the MoE's (``aux_loss``, ``expert_load``, ``capacity``) or {};
    cache_entry is None unless return_cache, in which case it holds this
    layer's part of the decode cache (the per-layer structure of
    cache_init): K/V zero-padded to cache_span, or for sliding attention
    the last min(cache_span, window) rows in ring order; the SSD state
    (hybrid); the WKV state and both token shifts (ssm); and with
    ``enc_out`` (an encoder-decoder's decoder layer) the cross attention's
    K/V over the encoder output, ``ck`` and ``cv``. ``causal=False`` is
    the bidirectional self-attention of an encoder layer."""
    if cfg.family == "ssm":
        h, (state, last1) = ssm_mod.rwkv6_time_mix(
            p["time_mix"], apply_norm(p["norm1"], x, cfg.norm), cfg,
            backend=rt.ssm_backend, factored=rt.ssm_factored)
        x = x + h
        h, last2 = ssm_mod.rwkv6_channel_mix(
            p["channel_mix"], apply_norm(p["norm2"], x, cfg.norm))
        entry = ({"wkv_state": state, "shift1": last1, "shift2": last2}
                 if return_cache else None)
        return x + h, {}, entry

    with span("repro_torch.model.attention"):
        h_in = apply_norm(p["norm1"], x, cfg.norm)
        tp = _attn_tp(p["attn"], cfg)
        a_in = coll.copy_to(h_in, rt.mesh) if tp else h_in
        q, k, v = attn_mod.project_qkv(p["attn"], a_in, a_in, cfg)
        q, k = _rope_q_k(cfg, q, k, positions)
        window = cfg.window if cfg.attention_kind == "sliding" else 0
        o = attn_mod.attention(q, k, v, backend=rt.attention_backend,
                               causal=causal, window=window)
        h = o.reshape(*x.shape[:-1], -1) @ p["attn"]["wo"]
        if tp:
            h = coll.reduce_from(h, rt.mesh)
        entry = None
        if return_cache:
            k, v = _heads_all(k, rt, tp), _heads_all(v, rt, tp)
            if cfg.attention_kind == "sliding":
                ring = min(cache_span, window) if window else cache_span
                entry = {"k": _ring_from_prefill(k, ring),
                         "v": _ring_from_prefill(v, ring)}
            else:
                pad = (0, 0, 0, 0, 0, cache_span - k.shape[1])
                entry = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
                if rt.decode_partitioned and cfg.attention_kind == "full":
                    entry = {n: _seq_shard(t, rt) for n, t in entry.items()}
        if cfg.family == "hybrid":
            h_ssm, ssd_state = ssm_mod.ssd_mix(p["ssm"], h_in, cfg,
                                               backend=rt.ssm_backend,
                                               factored=rt.ssm_factored)
            h = (h + h_ssm) * 0.5
            if return_cache:
                entry["ssd_state"] = ssd_state
        x = x + h
    if enc_out is not None:          # cross attention (whisper's decoder)
        h_in = apply_norm(p["norm_cross"], x, cfg.norm)
        tp = _attn_tp(p["cross_attn"], cfg)
        if tp:
            h_in = coll.copy_to(h_in, rt.mesh)
            enc_out = coll.copy_to(enc_out, rt.mesh)
        q, ck, cv = attn_mod.project_qkv(p["cross_attn"], h_in, enc_out, cfg)
        o = attn_mod.attention(q, ck, cv, backend=rt.attention_backend,
                               causal=False)
        h = o.reshape(*x.shape[:-1], -1) @ p["cross_attn"]["wo"]
        x = x + (coll.reduce_from(h, rt.mesh) if tp else h)
        if return_cache:
            ck, cv = _heads_all(ck, rt, tp), _heads_all(cv, rt, tp)
            if rt.decode_partitioned:
                ck, cv = _seq_shard(ck, rt), _seq_shard(cv, rt)
            entry["ck"], entry["cv"] = ck, cv
    x, aux = _ffn(p, x, cfg, rt)
    return x, aux, entry


def stack_apply(layers: list, x, cfg: ModelConfig, rt: Runtime, positions,
                enc_out=None, *, causal: bool = True, stack: str = "layers"):
    """The layer stack's forward, for the loss, over ``layers``, a list of
    per-layer trees (:func:`~repro_torch._tree.layer_at` of the stacked
    tree, or the training step's per-layer leaves). Returns (x, aux): aux
    holds the MoE's ``aux_loss`` summed over layers (a zero f32 scalar
    without one) and, for the moe family, ``expert_load`` stacked (L, E).

    With ``rt.remat`` and autograd recording, each block of
    ``rt.layers_per_block`` layers (one layer when that does not divide
    the depth) runs under ``torch.utils.checkpoint``: only block inputs
    are kept, and the block's forward runs again in the backward (under
    a mesh, its weight gathers too). ``stack`` names the parameters'
    stack (``"layers"`` or ``"enc_layers"``) for their specs."""
    L = len(layers)
    k = max(1, rt.layers_per_block)
    if L % k:
        k = 1
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(x, lo: int, enc_out):
        aux_loss, loads = zero, []
        for p in layers[lo:lo + k]:
            x, aux, _ = layer_apply(local_layer(p, cfg, rt, stack), x, cfg,
                                    rt, positions, enc_out, causal=causal)
            if aux:
                aux_loss = aux_loss + aux["aux_loss"]
                loads.append(aux["expert_load"])
        return x, aux_loss, torch.stack(loads) if loads else None

    remat = rt.remat and torch.is_grad_enabled()
    aux_loss, loads = zero, []
    for lo in range(0, L, k):
        # no RNG runs inside a layer, and stashing the CUDA RNG state
        # would synchronise the host with the device at every block
        x, a, load = (checkpoint(block, x, lo, enc_out, use_reentrant=False,
                                 preserve_rng_state=False)
                      if remat else block(x, lo, enc_out))
        aux_loss = aux_loss + a
        if load is not None:
            loads.append(load)
    aux = {"aux_loss": aux_loss}
    if loads:
        aux["expert_load"] = torch.cat(loads)
    return x, aux


def stack_prefill(stacked, x, cfg: ModelConfig, rt: Runtime, positions,
                  enc_out=None, *, cache_span: int):
    """Forward that also collects the stacked (L, ...) decode cache
    (prefill): each entry of :func:`layer_apply`'s cache stacked over the
    layers (with ``enc_out``, the cross attention's ``ck`` and ``cv``
    too)."""
    L = num_layers_of(stacked)
    caches = None
    for i in range(L):
        x, _, entry = layer_apply(local_layer(layer_at(stacked, i), cfg, rt),
                                  x, cfg, rt, positions, enc_out,
                                  return_cache=True, cache_span=cache_span)
        if caches is None:
            caches = {n: t.new_empty((L, *t.shape)) for n, t in entry.items()}
        for n, t in entry.items():
            caches[n][i] = t
    return x, caches


# ================================================================= caches
def cache_init(cfg: ModelConfig, num_layers: int, batch: int, max_len: int,
               dtype, device) -> dict:
    """Stacked (L, ...) decode cache: K/V (L, B, span, Hkv, D) with span =
    max_len, or min(max_len, window) for sliding attention (a ring); the
    SSD state (L, B, H, N, hs) f32 (hybrid); the WKV state (L, B, H, hs,
    hs) f32 and the two token shifts (L, B, d) (ssm)."""
    L = num_layers
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    c: dict = {}
    if cfg.attention_kind != "none":
        span = (min(max_len, cfg.window) if cfg.attention_kind == "sliding"
                else max_len)
        shape = (L, batch, span, cfg.num_kv_heads, cfg.resolved_head_dim)
        c["k"] = torch.zeros(shape, **kw)
        c["v"] = torch.zeros(shape, **kw)
    if cfg.family in ("ssm", "hybrid"):
        hs = cfg.ssm.head_size
        H = cfg.d_model // hs
    if cfg.family == "hybrid":
        c["ssd_state"] = torch.zeros((L, batch, H, cfg.ssm.state_size, hs),
                                     **f32)
    if cfg.family == "ssm":
        c["wkv_state"] = torch.zeros((L, batch, H, hs, hs), **f32)
        c["shift1"] = torch.zeros((L, batch, cfg.d_model), **kw)
        c["shift2"] = torch.zeros((L, batch, cfg.d_model), **kw)
    return c


def paged_cache_init(cfg: ModelConfig, num_layers: int, num_pages: int,
                     page_size: int, dtype, device) -> dict:
    """Stacked (L, P, page_size, Hkv, D) paged KV pools. The pool is
    global — requests own *pages* via block tables, not slots — so there
    is no batch axis. Page 0 is the reserved null page (see
    :mod:`repro_torch.serving.pages`)."""
    if (cfg.family in ("ssm", "hybrid") or cfg.attention_kind != "full"
            or cfg.is_enc_dec):
        raise ValueError(
            "paged KV serving supports full-attention decoder-only "
            f"models; got family={cfg.family!r}, "
            f"attention_kind={cfg.attention_kind!r}, "
            f"enc_dec={cfg.is_enc_dec}")
    shape = (num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ================================================================== decode
def _rwkv6_decode(p, x, cache, cfg: ModelConfig):
    """One token through an rwkv6 block. x: (B,1,d); cache: this layer's
    {"wkv_state", "shift1", "shift2"}, written IN PLACE."""
    B, _, d = x.shape
    hs = cfg.ssm.head_size
    H = d // hs
    tm, cm = p["time_mix"], p["channel_mix"]
    h_in = apply_norm(p["norm1"], x, cfg.norm)
    prev = cache["shift1"][:, None]
    mix = tm["mix"].to(x.dtype)
    xr, xk, xv, xg, xw = (h_in + (prev - h_in) * mix[i] for i in range(5))
    r = (xr @ tm["wr"]).reshape(B, H, hs)
    k = (xk @ tm["wk"]).reshape(B, H, hs)
    v = (xv @ tm["wv"]).reshape(B, H, hs)
    g = F.silu(xg @ tm["wg"])[:, 0]
    ld = -torch.exp(tm["w0"] + torch.tanh(xw @ tm["wa"]) @ tm["wb"])
    ld = torch.clamp(ld, -12.0, -1e-4).reshape(B, H, hs)
    state, o = ssm_mod.linear_attention_step(
        cache["wkv_state"], r.float(), k.float(), v.float(), ld.float(),
        tm["u"])
    h = (ssm_mod.group_norm(o, tm).reshape(B, d).to(x.dtype) * g) @ tm["wo"]
    x = x + h[:, None]
    cache["wkv_state"].copy_(state)
    cache["shift1"].copy_(h_in[:, 0])
    h_in = apply_norm(p["norm2"], x, cfg.norm)
    prev = cache["shift2"][:, None]
    cmix = cm["mix"].to(x.dtype)
    xk = h_in + (prev - h_in) * cmix[0]
    xr = h_in + (prev - h_in) * cmix[1]
    kk = torch.square(torch.relu(xk @ cm["wk"]))
    x = x + torch.sigmoid(xr @ cm["wr"]) * (kk @ cm["wv"])
    cache["shift2"].copy_(h_in[:, 0])
    return x


def _ssd_decode(sp, h_in, state, cfg: ModelConfig):
    """One token through the SSD heads. h_in: (B,1,dm) normed input;
    ``state`` (B,H,N,hs) f32, written IN PLACE. Returns h_ssm (B, dm)."""
    B = h_in.shape[0]
    hs, N = cfg.ssm.head_size, cfg.ssm.state_size
    H = sp["wx"].shape[1] // hs
    xin = (h_in @ sp["wx"]).reshape(B, H, hs)
    z = F.silu(h_in @ sp["wz"])[:, 0]
    Bm = (h_in @ sp["wB"]).reshape(B, H, N)
    Cm = (h_in @ sp["wC"]).reshape(B, H, N)
    dt, ld = ssm_mod.ssd_decay(sp, h_in[:, 0])
    new, o = ssm_mod.linear_attention_step(
        state, Cm.float(), (Bm * dt[..., None].to(Bm.dtype)).float(),
        xin.float(), ld.expand(B, H, N))
    state.copy_(new)
    o = o + sp["D"][:, None] * xin.float()
    return (o.reshape(B, H * hs).to(h_in.dtype) * z) @ sp["wo"]


def _decode_attend(q, k_cache, v_cache, cache_len, cfg: ModelConfig,
                   rt: Runtime, tp: bool, partitioned: bool):
    """Decode attention of q (B,1,Hq_loc,D), this rank's query heads,
    against a cache holding every key/value head: over the whole cache
    (this rank's key/value heads of it under tensor parallelism), or
    with ``partitioned`` over this rank's slice of a sequence-sharded
    cache, all query heads gathered and the partials combined across
    ``model`` (then this rank's heads of the output taken back)."""
    if partitioned:
        hq = q.shape[2]
        q_all = _heads_all(q, rt, tp)
        o = coll.partitioned_decode_attention(q_all, k_cache, v_cache,
                                              cache_len, rt.mesh, "model")
        return _head_slice(o, rt, hq) if tp else o
    if tp:
        hkv = k_cache.shape[2] // coll.axis_size(rt.mesh, "model")
        k_cache = _head_slice(k_cache, rt, hkv)
        v_cache = _head_slice(v_cache, rt, hkv)
    return attn_mod.decode_attention_simple(q, k_cache, v_cache, cache_len)


def _cross_decode(p, x, cross_cache, cfg: ModelConfig, rt: Runtime):
    """One token's cross attention over an encoder-decoder's cross cache
    (this layer's ``ck``, ``cv``: (B, enc_len, Hkv, D)), every encoder
    position valid, through the plain decode attention as in the
    reference (no kernel); under ``decode_partitioned`` over the
    sequence-sharded cross cache. Returns the residual sum."""
    h_in = apply_norm(p["norm_cross"], x, cfg.norm)
    ca = p["cross_attn"]
    tp = _attn_tp(ca, cfg)
    q = h_in @ ca["wq"]
    if cfg.qkv_bias:
        q = q + ca["bq"]
    q = q.reshape(x.shape[0], 1, attn_mod.local_heads(ca, cfg)[0],
                  cfg.resolved_head_dim)
    enc_len = cross_cache["ck"].shape[1]
    if rt.decode_partitioned:
        enc_len *= coll.axis_size(rt.mesh, "model")
    o = _decode_attend(q, cross_cache["ck"], cross_cache["cv"], enc_len,
                       cfg, rt, tp, rt.decode_partitioned)
    h = o.reshape(*x.shape[:-1], -1) @ ca["wo"]
    return x + (coll.reduce_from(h, rt.mesh) if tp else h)


def _write_kv(cache, k, v, pos, span: int, sliding: bool, offset: int):
    """Write one token's k, v (B,Hkv,D) at ``pos`` (an int, or (B,) per
    row) into this rank's cache slice, which holds positions ``offset ..
    offset + S_loc - 1`` (a sliding ring: slot ``pos % span``); a row
    whose slot lies in another rank's slice writes nothing here."""
    s_loc = cache["k"].shape[1]
    if isinstance(pos, torch.Tensor):
        slot = ((pos % span if sliding else pos) - offset).long()
        if s_loc == span:                    # the whole cache: every row
            rows = torch.arange(k.shape[0], device=k.device)
            cache["k"][rows, slot] = k
            cache["v"][rows, slot] = v
            return
        rows = torch.nonzero((slot >= 0) & (slot < s_loc)).reshape(-1)
        cache["k"][rows, slot[rows]] = k[rows]
        cache["v"][rows, slot[rows]] = v[rows]
    else:
        slot = (pos % span if sliding else pos) - offset
        if 0 <= slot < s_loc:
            cache["k"][:, slot] = k
            cache["v"][:, slot] = v


def layer_decode(p, x, cache, pos, cfg: ModelConfig, rt: Runtime,
                 cross_cache=None):
    """Single-token step. x: (B,1,d); cache: this layer's entries (views of
    the stacked cache), written IN PLACE: K/V at ``pos`` (at ``pos % span``
    in a sliding ring), the SSD state, or the WKV state and token shifts;
    ``cross_cache``: this layer's cross attention K/V (encoder-decoder
    models), read only. Returns (x, cache).

    pos is a Python int (lockstep batch: every row writes the same slot)
    or a (B,) int tensor (continuous batching: each row carries its own
    position, writes its own slot, and masks its own valid length). The
    ssm family reads no position."""
    if cfg.family == "ssm":
        return _rwkv6_decode(p, x, cache, cfg), cache
    B = x.shape[0]
    sliding = cfg.attention_kind == "sliding"
    partitioned = rt.decode_partitioned and cfg.attention_kind == "full"
    # under ``partitioned`` this rank holds positions offset.. of the cache
    s_loc = cache["k"].shape[1]
    shards = coll.axis_size(rt.mesh, "model") if partitioned else 1
    span = s_loc * shards
    offset = coll.axis_index(rt.mesh, "model") * s_loc if partitioned else 0
    h_in = apply_norm(p["norm1"], x, cfg.norm)
    tp = _attn_tp(p["attn"], cfg)
    q, k, v = attn_mod.project_qkv(p["attn"], h_in, h_in, cfg)
    if isinstance(pos, torch.Tensor):
        q, k = _rope_q_k(cfg, q, k, _streams(cfg, pos.reshape(-1, 1)))
        cache_len = torch.clamp(pos + 1, max=span)
    else:
        q, k = _rope_q_k(cfg, q, k, _streams(
            cfg, torch.full((B, 1), pos, device=x.device)))
        cache_len = min(pos + 1, span)
    _write_kv(cache, _heads_all(k, rt, tp)[:, 0], _heads_all(v, rt, tp)[:, 0],
              pos, span, sliding, offset)
    o = _decode_attend(q, cache["k"], cache["v"], cache_len, cfg, rt, tp,
                       partitioned)
    h = o.reshape(*x.shape[:-1], -1) @ p["attn"]["wo"]
    if tp:
        h = coll.reduce_from(h, rt.mesh)
    if cfg.family == "hybrid":
        h_ssm = _ssd_decode(p["ssm"], h_in, cache["ssd_state"], cfg)
        h = (h + h_ssm[:, None]) * 0.5
    x = x + h
    if cross_cache is not None:
        x = _cross_decode(p, x, cross_cache, cfg, rt)
    return _ffn(p, x, cfg, rt)[0], cache


def stack_decode(stacked, x, caches, pos, cfg: ModelConfig, rt: Runtime,
                 cross_caches=None):
    """Decode one token through every layer; ``caches`` is updated IN
    PLACE and returned. ``cross_caches``: the stacked (L, ...) cross
    attention K/V of an encoder-decoder model, read only."""
    for i in range(num_layers_of(stacked)):
        cross = None if cross_caches is None else layer_at(cross_caches, i)
        x, _ = layer_decode(local_layer(layer_at(stacked, i), cfg, rt), x,
                            layer_at(caches, i), pos, cfg, rt,
                            cross_cache=cross)
    return x, caches


def _paged_attend(q, k_pool, v_pool, block_tables, lengths, rt: Runtime):
    """Backend switch for block-table attention: kernel K2 (its in-kernel
    page gather) for backend 'kernel', the gather-then-
    decode_attention_simple reference for 'dense'."""
    if rt.attention_backend == "kernel":
        return ops.paged_attention(q, k_pool, v_pool, block_tables, lengths)
    return attn_mod.paged_decode_attention_ref(q, k_pool, v_pool,
                                               block_tables, lengths)


def layer_decode_paged(p, x, cache, pos, block_tables, cfg: ModelConfig,
                       rt: Runtime):
    """Single-token step against the paged KV pool. x: (B,1,d); cache:
    this layer's {"k","v"} pools (P, page_size, Hkv, D), written IN PLACE;
    pos: (B,) int32 per-row positions; block_tables: (B, n_pages) int32
    physical page ids in logical order (retired rows all-null).

    Each row writes its new K/V at (table[pos // page_size],
    pos % page_size). Live rows own disjoint pages; retired rows all write
    into the null page 0, an in-place scatter with duplicate indices whose
    result is unspecified — harmless, because no live row's length reaches
    a null-page entry of its table. Attention runs over ``pos + 1`` tokens
    for every row, inactive ones included, as in the reference."""
    B = x.shape[0]
    with span("repro_torch.model.attention"):
        h_in = apply_norm(p["norm1"], x, cfg.norm)
        q, k, v = attn_mod.project_qkv(p["attn"], h_in, h_in, cfg)
        q, k = _rope_q_k(cfg, q, k, _streams(cfg, pos.reshape(-1, 1)))
        ps = cache["k"].shape[1]
        bidx = torch.arange(B, device=x.device)
        # clamp like the reference's gather, which clamps out-of-range indices
        col = torch.clamp(pos // ps, max=block_tables.shape[1] - 1).long()
        pages = block_tables[bidx, col].long()
        offs = (pos % ps).long()
        cache["k"][pages, offs] = k[:, 0]
        cache["v"][pages, offs] = v[:, 0]
        o = _paged_attend(q, cache["k"], cache["v"], block_tables,
                          (pos + 1).to(torch.int32), rt)
        x = x + o.reshape(*x.shape[:-1], -1) @ p["attn"]["wo"]
    return _ffn(p, x, cfg, rt)[0], cache


def stack_decode_paged(stacked, x, caches, pos, block_tables,
                       cfg: ModelConfig, rt: Runtime):
    """Paged decode through every layer; block tables are shared across
    layers (one logical address space, L physical pools). ``caches`` is
    updated IN PLACE and returned."""
    for i in range(num_layers_of(stacked)):
        x, _ = layer_decode_paged(layer_at(stacked, i), x,
                                  layer_at(caches, i), pos, block_tables,
                                  cfg, rt)
    return x, caches


def layer_prefill_chunk(p, x, cache, block_tables, start_pos: int,
                        cfg: ModelConfig, rt: Runtime):
    """Chunked-prefill layer step: write this chunk's K/V into the paged
    pool IN PLACE, then attend causally over the *gathered* logical
    history (pages written by earlier chunks plus this one). x: (B, C, d)
    at absolute positions ``start_pos .. start_pos + C - 1``.

    As in the reference, the gather runs outside any kernel and the scores
    go through ``dense_attention`` with ``q_offset``: the history is
    ``n_live * page_size`` keys, more than the chunk's C queries, and the
    keys past the chunk are masked causally."""
    B, C = x.shape[0], x.shape[1]
    positions = start_pos + torch.arange(C, device=x.device)
    with span("repro_torch.model.attention"):
        h_in = apply_norm(p["norm1"], x, cfg.norm)
        q, k, v = attn_mod.project_qkv(p["attn"], h_in, h_in, cfg)
        q, k = _rope_q_k(cfg, q, k, _streams(cfg, positions[None]))
        _, ps, Hkv, D = cache["k"].shape
        npag = block_tables.shape[1]
        pages = block_tables[:, positions // ps].long()             # (B, C)
        offs = (positions % ps).long().expand(B, C)
        cache["k"][pages, offs] = k
        cache["v"][pages, offs] = v
        idx = block_tables.long()
        k_all = cache["k"][idx].reshape(B, npag * ps, Hkv, D)
        v_all = cache["v"][idx].reshape(B, npag * ps, Hkv, D)
        o = attn_mod.dense_attention(q, k_all, v_all, causal=True,
                                     q_offset=start_pos)
        x = x + o.reshape(*x.shape[:-1], -1) @ p["attn"]["wo"]
    return _ffn(p, x, cfg, rt)[0], cache


def stack_prefill_chunk(stacked, x, caches, block_tables, start_pos: int,
                        cfg: ModelConfig, rt: Runtime):
    """One prompt chunk through the layer stack; ``caches`` (the paged
    pools) are updated IN PLACE and returned."""
    for i in range(num_layers_of(stacked)):
        x, _ = layer_prefill_chunk(layer_at(stacked, i), x,
                                   layer_at(caches, i), block_tables,
                                   start_pos, cfg, rt)
    return x, caches
