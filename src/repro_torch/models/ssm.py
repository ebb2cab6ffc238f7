"""Linear-attention / SSM layers: RWKV6 (Finch) and Mamba-2-style SSD.

The PyTorch counterpart of ``repro/models/ssm.py``. Both layers run one
primitive, a decayed linear-attention recurrence

    S_t = diag(exp(ld_t)) . S_{t-1} + k_t (x) v_t          (state: K x V)
    o_t = q_t @ S_{t-1} + (q_t . u . k_t) v_t              (rwkv6: bonus u)
    o_t = q_t @ S_t                                        (ssd)

through one of three backends of :func:`linear_attention`:

* ``recurrent`` — the exact per-token recurrence (the oracle);
* ``chunked``   — the chunk-parallel form: cross-chunk state recurrence
  plus intra-chunk pairwise-decay attention, every decay factor
  exp(<= 0); optionally ``factored`` (two-level, no (c, c, K) tensor).
  The training path, as in the reference;
* ``kernel``    — kernel B6 (:func:`repro_torch.kernels.ops.wkv6`,
  chunks of 64; its plain version on CPU tensors), forward only. It
  stands where the JAX package has ``pallas``.

Shapes: q, k, ld (B,T,H,K); v (B,T,H,V); state (B,H,K,V). For SSD the
decay is one scalar per head, broadcast over K = state_size.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
# the plain recurrence lives with the kernels' plain versions, so the
# kernel layer depends on nothing above it
from repro_torch.kernels.ref import (linear_attention_step,
                                     recurrent_linear_attention)
from repro_torch.models.layers import normal

__all__ = ["chunked_linear_attention", "group_norm", "linear_attention",
           "linear_attention_step", "recurrent_linear_attention",
           "rwkv6_channel_mix", "rwkv6_channel_mix_init", "rwkv6_init",
           "rwkv6_time_mix", "ssd_init", "ssd_mix"]


# ------------------------------------------------------------- primitive
def chunked_linear_attention(q, k, v, ld, u=None, initial_state=None,
                             chunk: int = 64, factored: bool = False,
                             sub: int = 16):
    """Chunk-parallel decayed linear attention. Per chunk, in f32: the
    intra-chunk pairwise-decay attention, the bonus diagonal (rwkv6), the
    carried state's contribution and the state recurrence; o in q's dtype.
    Any T (the last chunk is padded with ld = 0 and k = 0).

    Every chunk's intra-chunk terms and its own key-value sum are computed
    at once (the chunks are a batch dimension); only the state entering
    each chunk, S_{i+1} = e^{p_last_i} S_i + kv_i, is a loop over chunks,
    of two small operations each. A loop over chunks of the whole chunk
    body made training host-bound on the card (PERF.md, Findings).

    factored=True: two-level intra-chunk scheme. Cross-sub-chunk terms
    factor around the sub-chunk boundary b (s < b <= t),
    A[t,s] = (q_t exp(w_t - p_b)) . (k_s exp(p_b - p_s)), both factors
    exp(<= 0); only the (sub x sub) diagonal blocks need the pairwise
    tensor."""
    B, T, H, K = q.shape
    V = v.shape[-1]
    dtype = q.dtype
    f32 = torch.float32
    c = min(chunk, T)
    pad = (-T) % c
    if pad:
        z = (0, 0, 0, 0, 0, pad)
        q, k, v = (F.pad(a, z) for a in (q, k, v))
        ld = F.pad(ld, z)   # ld = 0: decay 1; padded k = 0 adds nothing
    n = q.shape[1] // c
    dev = q.device
    tg = torch.arange(c, device=dev)
    mask = (tg[:, None] >= tg[None, :]) if u is None else (
        tg[:, None] > tg[None, :])
    S = (initial_state.to(f32) if initial_state is not None
         else torch.zeros((B, H, K, V), dtype=f32, device=dev))
    r = min(sub, c)
    nsub = c // r if c % r == 0 else 0
    sg = torch.arange(r, device=dev)
    smask = (sg[:, None] >= sg[None, :]) if u is None else (
        sg[:, None] > sg[None, :])

    # chunks as a batch: (B * n, c, H, *)
    def intra_pairwise(qi, ki, vi, w, p):
        diff = (w[:, :, None] - p[:, None, :]).masked_fill(
            ~mask[None, :, :, None, None], float("-inf"))     # (N,c,c,H,K)
        a = torch.einsum("bthk,bshk,btshk->bhts", qi, ki, torch.exp(diff))
        return torch.einsum("bhts,bshv->bthv", a, vi)

    def intra_factored(qi, ki, vi, w, p):
        N = qi.shape[0]
        qs, ks, we, pi = (a.reshape(N, nsub, r, H, K)
                          for a in (qi, ki, w, p))
        vs = vi.reshape(N, nsub, r, H, V)
        # diagonal blocks: pairwise over r only
        dd = (we[:, :, :, None] - pi[:, :, None, :]).masked_fill(
            ~smask[None, None, :, :, None, None], float("-inf"))
        ad = torch.einsum("bnthk,bnshk,bntshk->bnhts", qs, ks, torch.exp(dd))
        o = torch.einsum("bnhts,bnshv->bnthv", ad, vs)
        # cross-sub-chunk terms through a sub-chunk state recurrence, the
        # state referenced to the end of the previous sub-chunk
        p_end = pi[:, :, -1]                                  # (N,n,H,K)
        p_end_prev = torch.cat([torch.zeros_like(p_end[:, :1]),
                                p_end[:, :-1]], 1)
        k_dec = ks * torch.exp(p_end[:, :, None] - pi)
        kv_sub = torch.einsum("bnrhk,bnrhv->bnhkv", k_dec, vs)
        q_dec = qs * torch.exp(we - p_end_prev[:, :, None])
        ssub = torch.zeros((N, H, K, V), dtype=f32, device=dev)
        cross = []
        for j in range(nsub):
            cross.append(torch.einsum("brhk,bhkv->brhv", q_dec[:, j], ssub))
            ssub = (torch.exp(p_end[:, j] - p_end_prev[:, j])[..., None]
                    * ssub + kv_sub[:, j])
        return (o + torch.stack(cross, 1)).reshape(N, c, H, V)

    intra = intra_factored if (factored and nsub) else intra_pairwise
    qc, kc, vc, ldc = (a.to(f32).reshape(B * n, c, H, -1)
                       for a in (q, k, v, ld))
    p = torch.cumsum(ldc, dim=1)                            # (B n,c,H,K)
    w = p if u is None else p - ldc
    o = intra(qc, kc, vc, w, p)
    if u is not None:                                       # bonus diagonal
        diag = torch.einsum("bthk,hk,bthk->bth", qc, u.to(f32), kc)
        o = o + diag[..., None] * vc
    # the state entering each chunk, then its contribution
    p_last = p[:, -1]                                       # (B n,H,K)
    kv = torch.einsum("bthk,bthv->bhkv", kc * torch.exp(p_last[:, None] - p),
                      vc).reshape(B, n, H, K, V)
    decay = torch.exp(p_last).reshape(B, n, H, K, 1)
    entering = []
    for i in range(n):
        entering.append(S)
        S = decay[:, i] * S + kv[:, i]
    s_in = torch.stack(entering, 1).reshape(B * n, H, K, V)
    o = o + torch.einsum("bthk,bhkv->bthv", qc * torch.exp(w), s_in)
    o = o.to(dtype).reshape(B, n * c, H, V)
    return o[:, :T], S


def linear_attention(q, k, v, ld, u=None, initial_state=None, *,
                     backend: str = "chunked", chunk: int = 64,
                     factored: bool = False):
    """Backend switch (see the module docstring). ``chunk`` and
    ``factored`` apply to ``chunked``; ``kernel`` runs B6's chunks of
    64."""
    if backend == "recurrent":
        return recurrent_linear_attention(q, k, v, ld, u, initial_state)
    if backend == "chunked":
        return chunked_linear_attention(q, k, v, ld, u, initial_state,
                                        chunk=chunk, factored=factored)
    if backend == "kernel":
        return ops.wkv6(q, k, v, ld, u, initial_state)
    raise ValueError(f"unknown ssm backend {backend!r}; expected "
                     "'kernel', 'chunked' or 'recurrent'")


def _token_shift(x, prev):
    """x shifted one token right along T, ``prev`` (B, d) in front: the
    last token of the previous segment (zeros at the start)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


# ------------------------------------------------------------- RWKV6 layer
def rwkv6_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d = cfg.d_model
    hs = cfg.ssm.head_size
    H = d // hs
    s = 1.0 / math.sqrt(d)
    lora = max(32, d // 32)
    dev = gen.device
    f32 = torch.float32
    return {
        "mix": torch.full((5, d), 0.5, dtype=f32, device=dev),  # r,k,v,g,w
        "wr": normal(gen, (d, d), s, dtype),
        "wk": normal(gen, (d, d), s, dtype),
        "wv": normal(gen, (d, d), s, dtype),
        "wg": normal(gen, (d, d), s, dtype),
        "wo": normal(gen, (d, d), s, dtype),
        "w0": torch.full((d,), -6.0, dtype=f32, device=dev),   # base decay
        "wa": normal(gen, (d, lora), s, dtype),
        "wb": normal(gen, (lora, d), 0.01, dtype),
        "u": normal(gen, (H, hs), 0.1, f32),
        "ln_scale": torch.ones((H, hs), dtype=f32, device=dev),  # group norm
        "ln_bias": torch.zeros((H, hs), dtype=f32, device=dev),
    }


def rwkv6_time_mix(p, x, cfg: ModelConfig, *, backend: str, state=None,
                   shift_prev=None, factored: bool = False):
    """x: (B,T,d). Returns (out, (wkv_state, last_token)). The chunked
    backend uses ``cfg.ssm.chunk_size``."""
    B, T, d = x.shape
    hs = cfg.ssm.head_size
    H = d // hs
    prev = shift_prev if shift_prev is not None else x.new_zeros((B, d))
    xx = _token_shift(x, prev)
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + (xx - x) * mix[i] for i in range(5))
    r = (xr @ p["wr"]).reshape(B, T, H, hs)
    k = (xk @ p["wk"]).reshape(B, T, H, hs)
    v = (xv @ p["wv"]).reshape(B, T, H, hs)
    g = F.silu(xg @ p["wg"])
    # data-dependent per-channel log decay (LoRA), always negative
    ld = -torch.exp(p["w0"] + torch.tanh(xw @ p["wa"]) @ p["wb"])
    ld = torch.clamp(ld, -12.0, -1e-4).reshape(B, T, H, hs)
    o, new_state = linear_attention(r, k, v, ld, u=p["u"],
                                    initial_state=state, backend=backend,
                                    chunk=cfg.ssm.chunk_size,
                                    factored=factored)
    out = (group_norm(o, p).reshape(B, T, d).to(x.dtype) * g) @ p["wo"]
    return out, (new_state, x[:, -1])


def group_norm(o, p):
    """rwkv6's per-head group norm over the last axis, in f32."""
    of = o.float()
    mean = of.mean(-1, keepdim=True)
    var = ((of - mean) ** 2).mean(-1, keepdim=True)
    return (of - mean) * torch.rsqrt(var + 1e-5) * p["ln_scale"] \
        + p["ln_bias"]


def rwkv6_channel_mix_init(gen: torch.Generator, cfg: ModelConfig,
                           dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mix": torch.full((2, d), 0.5, dtype=torch.float32,
                          device=gen.device),
        "wk": normal(gen, (d, f), 1.0 / math.sqrt(d), dtype),
        "wv": normal(gen, (f, d), 1.0 / math.sqrt(f), dtype),
        "wr": normal(gen, (d, d), 1.0 / math.sqrt(d), dtype),
    }


def rwkv6_channel_mix(p, x, *, shift_prev=None):
    """x: (B,T,d). Returns (out, last_token)."""
    B, T, d = x.shape
    prev = shift_prev if shift_prev is not None else x.new_zeros((B, d))
    xx = _token_shift(x, prev)
    mix = p["mix"].to(x.dtype)
    xk = x + (xx - x) * mix[0]
    xr = x + (xx - x) * mix[1]
    kk = torch.square(torch.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (kk @ p["wv"]), x[:, -1]


# ------------------------------------------------------------- SSD (hymba)
def ssd_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    dm = cfg.d_model
    hs = cfg.ssm.head_size
    d = hs * max(1, dm // hs)
    H = d // hs
    N = cfg.ssm.state_size
    s = 1.0 / math.sqrt(dm)
    dev = gen.device
    f32 = torch.float32
    return {
        "wx": normal(gen, (dm, d), s, dtype),
        "wz": normal(gen, (dm, d), s, dtype),
        "wB": normal(gen, (dm, H * N), s, dtype),
        "wC": normal(gen, (dm, H * N), s, dtype),
        "wdt": normal(gen, (dm, H), s, dtype),
        "dt_bias": torch.zeros((H,), dtype=f32, device=dev),
        "A_log": torch.zeros((H,), dtype=f32, device=dev),
        "D": torch.ones((H,), dtype=f32, device=dev),
        "wo": normal(gen, (d, dm), 1.0 / math.sqrt(d), dtype),
    }


def ssd_decay(p, x):
    """(dt, ld) of the SSD mix for x (..., dm): dt = softplus(x wdt +
    dt_bias) (..., H) f32 and the per-head log decay ld = clip(-dt
    e^{A_log}, -12, -1e-6) as (..., H, 1)."""
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])
    ld = torch.clamp((-dt * torch.exp(p["A_log"]))[..., None], -12.0, -1e-6)
    return dt, ld


def ssd_mix(p, x, cfg: ModelConfig, *, backend: str, state=None,
            factored: bool = False):
    """Mamba-2-style SSD head mix. x: (B,T,dm) -> (out, state). The
    chunked backend uses ``cfg.ssm.chunk_size``."""
    B, T, dm = x.shape
    hs = cfg.ssm.head_size
    N = cfg.ssm.state_size
    H = p["wx"].shape[1] // hs
    xin = (x @ p["wx"]).reshape(B, T, H, hs)
    z = F.silu(x @ p["wz"])
    Bm = (x @ p["wB"]).reshape(B, T, H, N)
    Cm = (x @ p["wC"]).reshape(B, T, H, N)
    dt, ld = ssd_decay(p, x)
    ld = ld.expand(B, T, H, N)               # a view: stride 0 along N
    k = Bm * dt[..., None].to(Bm.dtype)      # discretized input
    o, new_state = linear_attention(Cm, k, xin, ld, u=None,
                                    initial_state=state, backend=backend,
                                    chunk=cfg.ssm.chunk_size,
                                    factored=factored)
    o = o + p["D"][:, None] * xin.float()
    out = (o.reshape(B, T, H * hs).to(x.dtype) * z) @ p["wo"]
    return out, new_state
