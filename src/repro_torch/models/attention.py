"""Attention: GQA projections, the dense reference, decode attention and
the backend switch.

The PyTorch counterpart of ``repro/models/attention.py``. Backends of
:func:`attention`:

* ``dense``  — materializes the (Sq, Sk) score matrix in f32;
* ``kernel`` — kernel K1, the hand-written flash-attention forward
  (:func:`repro_torch.kernels.ops.flash_attention`; its plain version on
  CPU tensors). It stands where the JAX package has ``pallas``.

All take q:(B,S,Hq,D), k/v:(B,Sk,Hkv,D) with Hq a multiple of Hkv and
never materialize repeated KV heads.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
# the plain attention functions live with the kernels' plain versions, so
# the kernel layer depends on nothing above it
from repro_torch.kernels.ref import (NEG_INF, decode_attention_simple,
                                     dense_attention,
                                     paged_decode_attention_ref)
from repro_torch.models.layers import normal

__all__ = ["NEG_INF", "attention", "attn_init", "decode_attention_simple",
           "dense_attention", "local_heads", "paged_decode_attention_ref",
           "project_qkv"]


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": normal(gen, (d, nq * hd), s, dtype),
        "wk": normal(gen, (d, nkv * hd), s, dtype),
        "wv": normal(gen, (d, nkv * hd), s, dtype),
        "wo": normal(gen, (nq * hd, d), 1.0 / math.sqrt(nq * hd), dtype),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros(n * hd, dtype=dtype, device=gen.device)
    return p


def local_heads(p, cfg: ModelConfig) -> tuple:
    """(query heads, key/value heads) the projections ``p`` hold: all of
    them, or under tensor parallelism this rank's Hq/m and Hkv/m."""
    hd = cfg.resolved_head_dim
    return p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd


def project_qkv(p, xq, xkv, cfg: ModelConfig):
    """Returns q:(B,S,Hq,D), k,v:(B,Sk,Hkv,D), with the head counts of the
    projections' (possibly tensor-parallel) shards."""
    hd = cfg.resolved_head_dim
    hq, hkv = local_heads(p, cfg)
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(*q.shape[:-1], hq, hd)
    k = k.reshape(*k.shape[:-1], hkv, hd)
    v = v.reshape(*v.shape[:-1], hkv, hd)
    return q, k, v


def attention(q, k, v, *, backend: str, causal: bool,
              window: int = 0) -> torch.Tensor:
    if backend == "dense":
        return dense_attention(q, k, v, causal=causal, window=window)
    if backend == "kernel":
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attention backend {backend!r}; "
                     "expected 'dense' or 'kernel'")
