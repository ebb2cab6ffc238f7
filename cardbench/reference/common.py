"""The plain reference's shared parts, in plain PyTorch and float32 with
TF32 off: the products (or, for the control, the same products with every
operand rounded to TF32, forward and backward), RMSNorm, rotary
embeddings, grouped-query attention, the SwiGLU MLP, the tied or untied
output head and its loss, the decoder stack, and AdamW.

It imports nothing of the program and reads only the weight tree and the
tokens the benchmark made. Where it departs from a published description
it does what the configuration file states the program runs, and says so:

* rotary frequencies are computed as numpy float32, theta^(-i/half), and
  the angles as float32 products, as the configuration as run fixes them
  (half-split rotation, no NTK scaling);
* AdamW decays every leaf of two or more dimensions in the stored layout,
  which with the stacked (layers, d) norm scales decays the layers' norm
  scales and not the final norm's: the update the run configuration
  states;
* the loss is the mean next-token NLL over the true vocabulary.
"""
from __future__ import annotations

import importlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def fp32_only() -> None:
    """Keep every float32 product in float32 (no TF32) on this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest), kept in float32."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _unbroadcast(g: torch.Tensor, shape) -> torch.Tensor:
    while g.dim() > len(shape):
        g = g.sum(0)
    for ax, n in enumerate(shape):
        if n == 1 and g.shape[ax] != 1:
            g = g.sum(ax, keepdim=True)
    return g


class _TF32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32(a), tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32(g)
        return (_unbroadcast(rg @ rb.transpose(-1, -2), ra.shape),
                _unbroadcast(ra.transpose(-1, -2) @ rg, rb.shape))


def matmul_of(precision: str):
    """The product of the reference ("float32") or of its control
    ("tf32": both operands rounded to TF32, in the backward too)."""
    if precision == "float32":
        return torch.matmul
    if precision == "tf32":
        return _TF32Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta: float):
    """x (B, S, H, D) rotated at ``positions`` (S,): the half-split
    rotation, x1 cos - x2 sin and x2 cos + x1 sin."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    freqs = torch.from_numpy(np.asarray(freqs, np.float32)).to(x.device)
    ang = positions.float()[:, None] * freqs
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, *, window: int, mm):
    """Causal grouped-query attention, q (B, S, Hq, D) and k, v (B, S,
    Hkv, D): query head h reads key head h // (Hq / Hkv); a key more than
    ``window - 1`` positions back is masked (window > 0)."""
    B, S, Hq, D = q.shape
    g = Hq // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(g, dim=1)
    s = mm(qh, kh.transpose(-1, -2)) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    keep = pos[:, None] >= pos[None, :]
    if window:
        keep &= pos[:, None] - pos[None, :] < window
    s = s.masked_fill(~keep, NEG_INF)
    o = mm(torch.softmax(s, dim=-1), vh)
    return o.transpose(1, 2)


def self_attention(p, h, positions, c, mm):
    """Projections, rotary embeddings and attention of one layer: the
    attention output before its residual, (B, S, d)."""
    B, S, _ = h.shape
    hd = c["head_dim"]
    q = mm(h, p["wq"]).reshape(B, S, -1, hd)
    k = mm(h, p["wk"]).reshape(B, S, -1, hd)
    v = mm(h, p["wv"]).reshape(B, S, -1, hd)
    q = rope(q, positions, c["rope_theta"])
    k = rope(k, positions, c["rope_theta"])
    o = attention(q, k, v, window=c.get("sliding_window", 0), mm=mm)
    return mm(o.reshape(B, S, -1), p["wo"])


def mlp(p, h, mm):
    return mm(F.silu(mm(h, p["w_gate"])) * mm(h, p["w_in"]), p["w_out"])


def layer_at(tree, i: int):
    """Layer i of the stacked layer tree, as views."""
    return {k: layer_at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def block_module(c: dict):
    """The configuration's block, ``reference/<c["reference"]>.py``."""
    return importlib.import_module(f"cardbench.reference.{c['reference']}")


def hidden(params, tokens, c, mm, *, remat: bool):
    """The final-normed hidden states (B, S, d) of ``tokens`` (B, S)."""
    block = block_module(c)
    x = params["embed"]["tok"][tokens.long()]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(c["num_hidden_layers"]):
        p = layer_at(params["layers"], i)
        if remat and torch.is_grad_enabled():
            x = checkpoint(block.layer, p, x, positions, c, mm,
                           use_reentrant=False)
        else:
            x = block.layer(p, x, positions, c, mm)
    return rmsnorm(x, params["final_norm"]["scale"], c["rms_norm_eps"])


def logits(params, x, c, mm):
    """Logits over the true vocabulary."""
    V = c["vocab_size"]
    if c["tie_word_embeddings"]:
        return mm(x, params["embed"]["tok"][:V].transpose(0, 1))
    return mm(x, params["embed"]["head"][:, :V])


def loss(params, tokens, labels, c, mm, *, remat: bool = True):
    """Mean next-token NLL of ``labels`` (B, S)."""
    lg = logits(params, hidden(params, tokens, c, mm, remat=remat), c, mm)
    gold = lg.gather(-1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(lg, -1) - gold).mean()


# ----------------------------------------------------------------- AdamW
def warmup_cosine(step: int, base: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> float:
    if step < warmup:
        return base * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base * (final_frac + (1 - final_frac) * 0.5
                   * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw(params: list, grads: list, state: dict, opt: dict) -> float:
    """One AdamW step over the leaves ``params`` with ``grads``, IN PLACE,
    after clipping the gradients' global norm to ``opt["grad_clip"]``;
    decoupled weight decay on leaves of two or more dimensions. Returns
    the clip factor."""
    state["step"] = step = state.get("step", 0) + 1
    lr = warmup_cosine(step, opt["lr"], opt["warmup_steps"],
                       opt["total_steps"])
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
    clip = torch.clamp(opt["grad_clip"] / torch.clamp(gnorm, min=1e-8),
                       max=1.0)
    ms = state.setdefault("m", [torch.zeros_like(p) for p in params])
    vs = state.setdefault("v", [torch.zeros_like(p) for p in params])
    for p, g, m, v in zip(params, grads, ms, vs):
        g = g * clip
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m / (1 - b1 ** step)) / ((v / (1 - b2 ** step)).sqrt() + eps)
        if p.dim() >= 2 and wd:
            upd = upd + wd * p
        p.add_(upd, alpha=-lr)
    return float(clip)
