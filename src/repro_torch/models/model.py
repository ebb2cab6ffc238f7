"""Top-level model API: ``build(cfg, rt, device=...) -> Model`` with
init/loss/prefill/decode and the paged serving triple.

The PyTorch counterpart of ``repro/models/model.py`` for the dense, ssm
and hybrid families (``batch = {"tokens": (B,S) int, "labels": (B,S)
int}``); moe, audio and vlm are ported in later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch._tree import layer_at
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_norm, embed_tokens,
                                       embedding_init, lm_logits, norm_init)
from repro_torch.models.transformer import Runtime


def resolve_device(device) -> torch.device:
    """The device a model or engine runs on. CUDA is the default of every
    entry point and never falls back: without a card it raises. On CUDA
    the f32 matrix products are pinned to full f32 (no TF32), as the
    reference computes them."""
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
    elif device.type != "cpu":
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


PORTED_FAMILIES = ("dense", "ssm", "hybrid")


def build(cfg: ModelConfig, rt: Runtime = Runtime(),
          param_dtype=torch.float32, device="cuda") -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port "
            f"builds the {', '.join(PORTED_FAMILIES)} families (moe, audio "
            "and vlm come with the 'other families' slice, ROADMAP.md queue "
            "A)")
    device = resolve_device(device)
    compute_dtype = param_dtype

    def init_params(gen: torch.Generator) -> dict:
        """Random parameters in the JAX layout, drawn from ``gen`` (a
        ``torch.Generator`` on the model's device)."""
        if gen.device != device:
            raise ValueError(f"generator on {gen.device}, model on {device}")
        return {"embed": embedding_init(gen, cfg, param_dtype),
                "layers": tfm.stack_init(gen, cfg, cfg.num_layers,
                                         param_dtype),
                "final_norm": norm_init(cfg.d_model, cfg.norm, device)}

    def _head(params, x_last):
        # the last position of a (B>1, S, d) batch is a strided view; the
        # RMSNorm kernel takes contiguous rows
        x_last = apply_norm(params["final_norm"], x_last.contiguous(),
                            cfg.norm)
        logits = lm_logits(params["embed"], x_last, cfg.tie_embeddings,
                           true_vocab=cfg.vocab_size)
        return logits.float()[..., :cfg.vocab_size]

    def loss(params, batch):
        """Mean next-token NLL over ``batch["labels"]`` (B,S), from f32
        logits over the padded vocab (padded entries masked to -1e30).
        Returns (total, {"nll", "aux_loss"}), total = nll + aux_loss.
        ``params["layers"]`` is the stacked tree or a list of per-layer
        trees (the training step's leaves, see
        :func:`repro_torch.runtime.steps.build_train_step`)."""
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens).to(compute_dtype)
        positions = torch.arange(tokens.shape[1], device=x.device)[None]
        layers = params["layers"]
        if not isinstance(layers, list):
            layers = [layer_at(layers, i)
                      for i in range(tfm.num_layers_of(layers))]
        x, aux = tfm.stack_apply(layers, x, cfg, rt, positions)
        x = apply_norm(params["final_norm"], x, cfg.norm)
        logits = lm_logits(params["embed"], x, cfg.tie_embeddings,
                           true_vocab=cfg.vocab_size).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
        nll = (logz - gold).mean()
        return nll + aux["aux_loss"], {"nll": nll, **aux}

    def prefill(params, batch, cache_span: int):
        """batch["tokens"]: (B,S). Returns last-position logits (B,1,V)
        and the stacked decode caches padded to ``cache_span``."""
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens).to(compute_dtype)
        positions = torch.arange(tokens.shape[1], device=x.device)[None]
        x, layer_caches = tfm.stack_prefill(params["layers"], x, cfg, rt,
                                            positions, cache_span=cache_span)
        return _head(params, x[:, -1:]), {"layers": layer_caches}

    def decode_step(params, caches, token, pos):
        """token: (B,1); pos: an int (next position to write) or a (B,)
        tensor of per-row positions. Updates ``caches`` IN PLACE."""
        x = embed_tokens(params["embed"], token).to(compute_dtype)
        x, _ = tfm.stack_decode(params["layers"], x, caches["layers"], pos,
                                cfg, rt)
        return _head(params, x), caches

    def prefill_chunk(params, caches, tokens, block_tables, start_pos: int):
        """One chunk of a chunked prefill. tokens: (B, C) at absolute
        positions ``start_pos .. start_pos+C-1``; caches: paged pools from
        ``paged_cache_init``, written IN PLACE; block_tables: (B, n_pages)
        int32. Returns the chunk's LAST-position logits ((B, 1, V)) and
        the pools."""
        x = embed_tokens(params["embed"], tokens).to(compute_dtype)
        x, _ = tfm.stack_prefill_chunk(params["layers"], x, caches["layers"],
                                       block_tables, int(start_pos), cfg, rt)
        return _head(params, x[:, -1:]), caches

    def decode_step_paged(params, caches, token, pos, block_tables):
        """token: (B,1); pos: (B,) int32 next position per row;
        block_tables: (B, n_pages) int32. Updates the pools IN PLACE."""
        x = embed_tokens(params["embed"], token).to(compute_dtype)
        x, _ = tfm.stack_decode_paged(params["layers"], x, caches["layers"],
                                      pos, block_tables, cfg, rt)
        return _head(params, x), caches

    def paged_cache_init(num_pages: int, page_size: int,
                         dtype=param_dtype):
        return {"layers": tfm.paged_cache_init(cfg, cfg.num_layers,
                                               num_pages, page_size, dtype,
                                               device)}

    def cache_init(batch: int, max_len: int, dtype=param_dtype):
        return {"layers": tfm.cache_init(cfg, cfg.num_layers, batch,
                                         max_len, dtype, device)}

    return Model(cfg=cfg, rt=rt, init_params=init_params, loss=loss,
                 prefill=prefill, decode_step=decode_step,
                 cache_init=cache_init, prefill_chunk=prefill_chunk,
                 decode_step_paged=decode_step_paged,
                 paged_cache_init=paged_cache_init)
