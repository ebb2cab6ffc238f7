"""Plain PyTorch versions of the three kernels of the serving path, and
the plain attention functions that the model layer also calls directly
(``dense_attention`` in chunked prefill, ``decode_attention_simple`` in
continuous decode; ``repro_torch.models.attention`` re-exports them). The
CPU runs them in place of the kernels; the CPU tests hold them to the JAX
package, and ``chip_smoke.py`` holds each kernel to its plain version on
the card. This module imports nothing of the port."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


# ------------------------------------------------------------------ dense
def dense_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Reference backend. Handles GQA by reshaping q into groups; the
    softmax weights are cast to q's dtype before the PV product, as in
    the JAX reference."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, g, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(D)
    scores = scores.float()
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(B, Sq, Hq, D)


# ------------------------------------------------------------------ decode
def decode_attention_simple(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """One-token decode against a full cache. q:(B,1,Hq,D),
    caches:(B,Smax,Hkv,D); positions >= cache_len are masked. cache_len is
    a scalar (lockstep batch) or a (B,) tensor (continuous batching: each
    slot carries its own valid length)."""
    B, _, Hq, D = q.shape
    _, Sk, Hkv, _ = k_cache.shape
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache) / math.sqrt(D)
    s = s.float()
    if isinstance(cache_len, torch.Tensor):
        cache_len = cache_len.reshape(-1, 1)
    valid = torch.arange(Sk, device=q.device)[None, :] < cache_len
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhgk,bkhd->bhgd", w, v_cache)
    return o.reshape(B, 1, Hq, D)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                               lengths) -> torch.Tensor:
    """Reference paged decode attention: gather the per-row pages into a
    contiguous logical cache and reuse :func:`decode_attention_simple`.
    q:(B,1,Hq,D); k_pages/v_pages:(P,ps,Hkv,D); block_tables:(B,npag)
    physical page ids in logical order; lengths:(B,) valid KV tokens."""
    B = q.shape[0]
    _, ps, Hkv, D = k_pages.shape
    npag = block_tables.shape[1]
    idx = block_tables.long()
    k = k_pages[idx].reshape(B, npag * ps, Hkv, D)
    v = v_pages[idx].reshape(B, npag * ps, Hkv, D)
    return decode_attention_simple(q, k, v, lengths)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Kernel K1's function: causal/windowed GQA attention, softmax in f32."""
    return dense_attention(q, k, v, causal=causal, window=window)


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    """Kernel K3's function: RMSNorm in f32, output in x's dtype."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)
