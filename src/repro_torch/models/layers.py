"""Shared building blocks: norms, rotary embeddings, MLPs, embeddings.

The PyTorch counterpart of ``repro/models/layers.py``: functional
``*_init(generator, ...) -> params`` and matching apply functions over
plain nested dicts of tensors, in the JAX package's layouts (``x @ W``
with ``W`` shaped ``(d_in, d_out)``). RMSNorm goes through kernel K3
(:func:`repro_torch.kernels.ops.rmsnorm`), which takes its plain version
on CPU tensors.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

# M-RoPE head-dim half split into (temporal, height, width) sections,
# per Qwen2-VL (arXiv:2409.12191).
MROPE_SECTIONS = (16, 24, 24)


def normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """N(0, std^2) samples drawn in f32 on the generator's device (on the
    ``meta`` device, the shape alone)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return t.normal_(generator=gen).mul_(std).to(dtype)


# ---------------------------------------------------------------- norms
def norm_init(d: int, kind: str, device) -> dict:
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def apply_norm(p, x, kind: str, eps: float = 1e-5):
    """Norm in f32, output in x's dtype."""
    if kind == "layernorm":
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
        return y.to(x.dtype)
    return ops.rmsnorm(x, p["scale"], eps=eps)


# ---------------------------------------------------------------- rotary
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` (the reference's numpy values) kept on the
    device: copying them from pageable host memory at every call would
    block the host on the device twice per layer."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). Angles in
    f32."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs_on(x.shape[-1], float(theta), x.device)
    ang = positions[..., None].float() * freqs                 # (..., S, half)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_sections(half: int) -> tuple:
    """The (t, h, w) split of a head's ``half`` rotary frequencies:
    MROPE_SECTIONS where they fill it, else (reduced configs) the same
    (1/4, 3/8, 3/8) proportions."""
    if sum(MROPE_SECTIONS) == half:
        return MROPE_SECTIONS
    s0 = half // 4
    s1 = (half - s0) // 2
    return (s0, s1, half - s0 - s1)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the rotary angle sections come from
    three position streams (t, h, w). x: (B, S, H, D); positions3: (B, 3,
    S), or (1, 3, S) for every row alike. Angles in f32."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs_on(x.shape[-1], float(theta), x.device)
    ang_all = positions3[..., None].float() * freqs            # (B,3,S,half)
    parts, start = [], 0
    for i, sec in enumerate(mrope_sections(half)):
        parts.append(ang_all[:, i, :, start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)                               # (B,S,half)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int) -> np.ndarray:
    """(seq, d) f32 absolute position embedding (whisper): sin on the even
    columns, cos on the odd, computed in float64 and rounded once, as the
    reference computes it."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / np.power(10000.0, dim / d)
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def sinusoidal_at(pos, d: int, device) -> torch.Tensor:
    """The sinusoidal embedding at run-time positions ``pos`` (an int or a
    1-D tensor) -> (len(pos), d) f32, computed in f32 on the device as the
    reference's decode computes it."""
    half_idx = torch.arange(0, d, 2, device=device, dtype=torch.float32)
    pos_v = torch.as_tensor(pos, dtype=torch.float32, device=device)
    ang = pos_v.reshape(-1)[:, None] / torch.pow(10000.0, half_idx / d)
    pe = torch.zeros((ang.shape[0], d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


# ---------------------------------------------------------------- mlp
def mlp_init(gen: torch.Generator, d: int, f: int, activation: str,
             dtype) -> dict:
    p = {"w_in": normal(gen, (d, f), 1.0 / math.sqrt(d), dtype),
         "w_out": normal(gen, (f, d), 1.0 / math.sqrt(f), dtype)}
    if activation == "swiglu":
        p["w_gate"] = normal(gen, (d, f), 1.0 / math.sqrt(d), dtype)
    return p


def apply_mlp(p, x, activation: str):
    if activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_in"])
    elif activation == "gelu":
        h = F.gelu(x @ p["w_in"], approximate="tanh")
    else:
        raise ValueError(activation)
    return h @ p["w_out"]


def apply_mlp_tp(p, x, activation: str, full_ff: int, mesh):
    """:func:`apply_mlp`, tensor-parallel where the hidden dim (``full_ff``
    wide) is sharded over the mesh's ``model`` axis: ``x`` enters through
    the copy region, the partial products leave through the reduce
    region."""
    if mesh is None or p["w_in"].shape[-1] == full_ff:
        return apply_mlp(p, x, activation)
    from repro_torch.parallel.collectives import copy_to, reduce_from
    return reduce_from(apply_mlp(p, copy_to(x, mesh), activation), mesh)


# ---------------------------------------------------------------- embedding
VOCAB_PAD = 256  # pad vocab so it always divides the model axis (MaxText-style)


def padded_vocab(vocab_size: int) -> int:
    return -(-vocab_size // VOCAB_PAD) * VOCAB_PAD


def embedding_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    pv = padded_vocab(cfg.vocab_size)
    p = {"tok": normal(gen, (pv, cfg.d_model), 0.02, dtype)}
    if not cfg.tie_embeddings:
        p["head"] = normal(gen, (cfg.d_model, pv), 0.02, dtype)
    return p


def embed_tokens(p, tokens):
    return p["tok"][tokens.long()]


def lm_logits(p, x, tie: bool, true_vocab: int = 0):
    """Logits over the PADDED vocab; padded entries masked to -1e30 when
    true_vocab is given."""
    logits = x @ p["tok"].T if tie else x @ p["head"]
    if true_vocab and logits.shape[-1] != true_vocab:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= true_vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits
