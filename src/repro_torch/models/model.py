"""Top-level model API: ``build(cfg, rt, device=...) -> Model`` with
init/loss/prefill/decode and the paged serving triple.

The PyTorch counterpart of ``repro/models/model.py``, for every family.
Input contract per family (the reference's):

* dense/moe/ssm/hybrid: ``batch = {"tokens": (B,S) int, "labels": (B,S)
  int}``;
* vlm and early fusion (``frontend="vision_stub"``): ``{"embeds": (B,S,d),
  "positions": (B,3,S) int (M-RoPE only), "labels"}``, the patch frontend
  stubbed; token batches are taken too;
* audio (whisper, encoder-decoder): ``{"audio_embeds": (B,S_enc,d),
  "tokens", "labels"}``, the conv/mel frontend stubbed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch._tree import layer_at
from repro_torch.configs.base import ModelConfig
from repro_torch.core.spans import span
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_norm, embed_tokens,
                                       embedding_init, lm_logits, norm_init,
                                       sinusoidal_at, sinusoidal_positions)
from repro_torch.models.transformer import Runtime
from repro_torch.parallel.layout import full_tree


def resolve_device(device) -> torch.device:
    """The device a model or engine runs on. CUDA is the default of every
    entry point and never falls back: without a card it raises. On CUDA
    the f32 matrix products are pinned to full f32 (no TF32), as the
    reference computes them. ``meta`` is taken as a shape-only device:
    nothing computes there (the dry run's, :mod:`repro_torch.launch.
    dryrun`), and the kernels' wrappers take their plain versions on it."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and this "
                "machine has none; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device}")
    return device


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    rt: Runtime
    init_params: Callable   # (generator) -> params
    loss: Callable          # (params, batch) -> (loss, aux)
    prefill: Callable       # (params, batch, cache_span) -> (logits, caches)
    decode_step: Callable   # (params, caches, token, pos) -> (logits, caches)
    cache_init: Callable    # (batch, max_len) -> zeroed caches
    # paged-KV serving triple:
    # (params, caches, tokens, block_tables, start_pos) -> (logits, caches)
    prefill_chunk: Callable
    # (params, caches, token, pos, block_tables) -> (logits, caches)
    decode_step_paged: Callable
    # (num_pages, page_size) -> zeroed paged pools
    paged_cache_init: Callable


def _per_layer(layers) -> list:
    """A stack as a list of per-layer trees: the stacked tree's layers
    (views), or the training step's list as it is."""
    if isinstance(layers, list):
        return layers
    return [layer_at(layers, i) for i in range(tfm.num_layers_of(layers))]


PORTED_FAMILIES = ("dense", "moe", "audio", "vlm", "ssm", "hybrid")


def _init_tree(gen, cfg: ModelConfig, param_dtype) -> dict:
    device = gen.device
    p = {"embed": embedding_init(gen, cfg, param_dtype),
         "layers": tfm.stack_init(gen, cfg, cfg.num_layers, param_dtype,
                                  cross=cfg.is_enc_dec),
         "final_norm": norm_init(cfg.d_model, cfg.norm, device)}
    if cfg.is_enc_dec:
        p["enc_layers"] = tfm.stack_init(gen, cfg, cfg.encoder_layers,
                                         param_dtype)
        p["enc_norm"] = norm_init(cfg.d_model, cfg.norm, device)
    return p


class _ShapeOnly:
    """Stands for a generator in :func:`abstract_params`: the init draws
    nothing on the ``meta`` device."""
    device = torch.device("meta")


def abstract_params(cfg: ModelConfig, param_dtype=torch.float32) -> dict:
    """The parameter tree of ``cfg`` as ``meta`` tensors: shapes and
    dtypes, no memory (what the sharding rules read, as the reference
    reads ``jax.eval_shape``)."""
    return _init_tree(_ShapeOnly(), cfg, param_dtype)


def build(cfg: ModelConfig, rt: Runtime = Runtime(),
          param_dtype=torch.float32, device="cuda") -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    device = resolve_device(device)
    compute_dtype = param_dtype

    def init_params(gen: torch.Generator) -> dict:
        """Random parameters in the JAX layout, drawn from ``gen`` (a
        ``torch.Generator`` on the model's device)."""
        if gen.device != device:
            raise ValueError(f"generator on {gen.device}, model on {device}")
        return _init_tree(gen, cfg, param_dtype)

    def _full_embed(params):
        """Under a mesh the embedding tables are sharded by vocabulary
        (and under streaming by width): each rank gathers them whole at
        use, and its gradient goes back to its shards."""
        if rt.mesh is None or rt.param_specs is None:
            return params
        return {**params, "embed": full_tree(
            params["embed"], rt.param_specs["embed"], rt.mesh)}

    def _one_device(what: str):
        if rt.mesh is not None:
            raise NotImplementedError(
                f"{what} runs on one device: the paged pools have no "
                "sharded layout")

    def _sinusoidal(n: int, dev) -> torch.Tensor:
        return torch.from_numpy(sinusoidal_positions(n, cfg.d_model)).to(dev)

    def _embed_inputs(params, batch):
        """(x, positions) for the decoder stack: the vision stub's
        ``embeds`` (with its M-RoPE ``positions``), or embedded tokens
        (whisper's plus the sinusoidal embedding; M-RoPE's three streams
        all at the token's position)."""
        if cfg.frontend == "vision_stub" and "embeds" in batch:
            x = batch["embeds"].to(compute_dtype)
            positions = (batch["positions"] if cfg.rope == "mrope" else
                         torch.arange(x.shape[1], device=x.device)[None])
            return x, positions
        x = embed_tokens(params["embed"], batch["tokens"]).to(compute_dtype)
        B, S = x.shape[:2]
        if cfg.rope == "sinusoidal":
            x = x + _sinusoidal(S, x.device).to(x.dtype)
        positions = torch.arange(S, device=x.device)[None]
        if cfg.rope == "mrope":
            positions = positions[:, None].expand(B, 3, S)
        return x, positions

    def _encode(params, batch):
        """The encoder of an encoder-decoder model over the audio stub's
        frame embeddings: sinusoidal positions, the bidirectional layer
        stack, the encoder norm."""
        if "audio_embeds" not in batch:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder model: its batches carry "
                "'audio_embeds' (B, S_enc, d) beside 'tokens'")
        x = batch["audio_embeds"].to(compute_dtype)
        x = x + _sinusoidal(x.shape[1], x.device).to(x.dtype)
        x, _ = tfm.stack_apply(_per_layer(params["enc_layers"]), x, cfg, rt,
                               torch.arange(x.shape[1], device=x.device)[None],
                               causal=False, stack="enc_layers")
        return apply_norm(params["enc_norm"], x, cfg.norm)

    def _head(params, x_last):
        # the last position of a (B>1, S, d) batch is a strided view; the
        # RMSNorm kernel takes contiguous rows
        with span("repro_torch.model.head"):
            x_last = apply_norm(params["final_norm"], x_last.contiguous(),
                                cfg.norm)
            logits = lm_logits(params["embed"], x_last, cfg.tie_embeddings,
                               true_vocab=cfg.vocab_size)
            return logits.float()[..., :cfg.vocab_size]

    def loss(params, batch):
        """Mean next-token NLL over ``batch["labels"]`` (B,S), from f32
        logits over the padded vocab (padded entries masked to -1e30).
        Returns (total, {"nll", "aux_loss"[, "expert_load"]}), total = nll
        + aux_loss (the MoE load-balance loss summed over layers; 0
        without one), ``expert_load`` (L, E) for the moe family.
        ``params["layers"]`` (and ``"enc_layers"``) is the stacked tree or
        a list of per-layer trees (the training step's leaves, see
        :func:`repro_torch.runtime.steps.build_train_step`). Under a
        mesh: this rank's rows of the batch and its shards of the
        params; the loss is its rows' mean."""
        params = _full_embed(params)
        enc_out = _encode(params, batch) if cfg.is_enc_dec else None
        x, positions = _embed_inputs(params, batch)
        x, aux = tfm.stack_apply(_per_layer(params["layers"]), x, cfg, rt,
                                 positions, enc_out)
        with span("repro_torch.model.head"):
            x = apply_norm(params["final_norm"], x, cfg.norm)
            logits = lm_logits(params["embed"], x, cfg.tie_embeddings,
                               true_vocab=cfg.vocab_size).float()
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
            nll = (logz - gold).mean()
        return nll + aux["aux_loss"], {"nll": nll, **aux}

    def prefill(params, batch, cache_span: int):
        """batch: the family's input (tokens, the vision stub's embeds, or
        whisper's audio embeds and tokens), S positions. Returns
        last-position logits (B,1,V) and the stacked decode caches padded
        to ``cache_span``; for an encoder-decoder model also
        ``caches["cross"]``, the cross attention's K/V over the encoder
        output."""
        params = _full_embed(params)
        enc_out = _encode(params, batch) if cfg.is_enc_dec else None
        x, positions = _embed_inputs(params, batch)
        x, layer_caches = tfm.stack_prefill(params["layers"], x, cfg, rt,
                                            positions, enc_out,
                                            cache_span=cache_span)
        caches = {"layers": layer_caches}
        if cfg.is_enc_dec:      # split the cross attention's K/V out
            caches["cross"] = {"ck": layer_caches.pop("ck"),
                               "cv": layer_caches.pop("cv")}
        return _head(params, x[:, -1:]), caches

    def _embed_at(params, tokens, pos):
        """Embedded tokens (B, C) at run-time positions ``pos`` (an int,
        (B,) per row, or (C,) per column), plus whisper's sinusoidal
        embedding there."""
        x = embed_tokens(params["embed"], tokens).to(compute_dtype)
        if cfg.rope == "sinusoidal":
            pe = sinusoidal_at(pos, cfg.d_model, x.device).to(x.dtype)
            x = x + (pe[None] if tokens.shape[1] > 1 else pe[:, None])
        return x

    def decode_step(params, caches, token, pos):
        """token: (B,1); pos: an int (next position to write) or a (B,)
        tensor of per-row positions. Updates ``caches`` IN PLACE."""
        params = _full_embed(params)
        x = _embed_at(params, token, pos)
        x, _ = tfm.stack_decode(params["layers"], x, caches["layers"], pos,
                                cfg, rt, cross_caches=caches.get("cross"))
        return _head(params, x), caches

    def prefill_chunk(params, caches, tokens, block_tables, start_pos: int):
        """One chunk of a chunked prefill. tokens: (B, C) at absolute
        positions ``start_pos .. start_pos+C-1``; caches: paged pools from
        ``paged_cache_init``, written IN PLACE; block_tables: (B, n_pages)
        int32. Returns the chunk's LAST-position logits ((B, 1, V)) and
        the pools."""
        _one_device("chunked prefill")
        start_pos = int(start_pos)
        x = _embed_at(params, tokens, torch.arange(
            start_pos, start_pos + tokens.shape[1]))
        x, _ = tfm.stack_prefill_chunk(params["layers"], x, caches["layers"],
                                       block_tables, start_pos, cfg, rt)
        return _head(params, x[:, -1:]), caches

    def decode_step_paged(params, caches, token, pos, block_tables):
        """token: (B,1); pos: (B,) int32 next position per row;
        block_tables: (B, n_pages) int32. Updates the pools IN PLACE."""
        _one_device("paged decode")
        x = _embed_at(params, token, pos)
        x, _ = tfm.stack_decode_paged(params["layers"], x, caches["layers"],
                                      pos, block_tables, cfg, rt)
        return _head(params, x), caches

    def paged_cache_init(num_pages: int, page_size: int,
                         dtype=param_dtype):
        return {"layers": tfm.paged_cache_init(cfg, cfg.num_layers,
                                               num_pages, page_size, dtype,
                                               device)}

    def cache_init(batch: int, max_len: int, dtype=param_dtype,
                   enc_len: int = 0):
        """Zeroed decode caches; an encoder-decoder model's also hold the
        cross attention's K/V, ``enc_len`` encoder positions (default
        ``max_len``)."""
        caches = {"layers": tfm.cache_init(cfg, cfg.num_layers, batch,
                                           max_len, dtype, device)}
        if cfg.is_enc_dec:
            shape = (cfg.num_layers, batch, enc_len or max_len,
                     cfg.num_kv_heads, cfg.resolved_head_dim)
            caches["cross"] = {
                "ck": torch.zeros(shape, dtype=dtype, device=device),
                "cv": torch.zeros(shape, dtype=dtype, device=device)}
        return caches

    return Model(cfg=cfg, rt=rt, init_params=init_params, loss=loss,
                 prefill=prefill, decode_step=decode_step,
                 cache_init=cache_init, prefill_chunk=prefill_chunk,
                 decode_step_paged=decode_step_paged,
                 paged_cache_init=paged_cache_init)
