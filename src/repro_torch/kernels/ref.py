"""Plain PyTorch versions of the port's kernels (the serving path's
forward kernels, the training path's attention forward-with-lse, dq
and dkv kernels, and the chunked WKV6 kernel), and
the plain functions that the model layer also calls directly
(``dense_attention`` in chunked prefill, ``decode_attention_simple`` in
continuous decode, ``linear_attention_step`` in ssm and hybrid decode;
``repro_torch.models.attention`` and ``repro_torch.models.ssm``
re-export them). The
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


# ------------------------------------------------------------ training
def _scaled_scores(q, k, causal: bool, window: int):
    """f32 scores of the pre-scaled q against k per q head, (B,Hq,Sq,Sk),
    and the (Sq,Sk) mask; GQA by repeating each kv head over its group."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2) * (1.0 / math.sqrt(D))   # (B,Hq,Sq,D)
    kf = k.float().transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    return qf @ kf.transpose(-1, -2), mask


def flash_attention_lse_ref(q, k, v, *, causal: bool = True,
                            window: int = 0):
    """The forward-with-lse kernel's function: K1's output and the
    logsumexp rows ``lse`` (B,Hq,Sq) f32 of the scaled, masked scores
    (masked scores -1e30, as in the kernel)."""
    s, mask = _scaled_scores(q, k, causal, window)
    lse = torch.logsumexp(s.masked_fill(~mask, NEG_INF), dim=-1)
    return flash_attention_ref(q, k, v, causal=causal, window=window), lse


def _probs_and_ds(q, k, v, do, lse, delta, causal: bool, window: int):
    """p = where(mask, exp(s - lse), 0) and ds = p * (dO V^T - delta),
    each (B,Hq,Sq,Sk) f32, with the TPU kernels' formulas."""
    s, mask = _scaled_scores(q, k, causal, window)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    g = q.shape[2] // k.shape[2]
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    dp = do.float().transpose(1, 2) @ vf.transpose(-1, -2)
    return p, p * (dp - delta[..., None])


def flash_attention_dq_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                           window: int = 0):
    """Kernel B3's function (``_dq_kernel``): dq = ds K * scale, in q's
    dtype. do like q; lse and delta (B,Hq,Sq) f32."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, window)
    kf = k.float().transpose(1, 2).repeat_interleave(
        q.shape[2] // k.shape[2], dim=1)
    dq = (ds @ kf) * (1.0 / math.sqrt(q.shape[-1]))
    return dq.transpose(1, 2).to(q.dtype)


def flash_attention_dkv_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                            window: int = 0):
    """Kernel B4's function (``_dkv_kernel`` and the group sum after it):
    dk = ds^T (q * scale), dv = p^T dO per q head in f32, summed over each
    GQA group, in k's and v's dtypes."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, window)
    qs = q.float().transpose(1, 2) * (1.0 / math.sqrt(D))
    dk = (ds.transpose(-1, -2) @ qs).reshape(B, Hkv, Hq // Hkv, Sk, D).sum(2)
    dv = (p.transpose(-1, -2) @ do.float().transpose(1, 2)).reshape(
        B, Hkv, Hq // Hkv, Sk, D).sum(2)
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def attention_delta(o, do):
    """delta = rowsum(dO * O) in f32, (B,Sq,Hq,D) -> (B,Hq,Sq), the plain
    reduction the backward kernels read (the TPU wrapper computes it
    outside its kernels too)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0):
    """The backward of the flash attention, with the TPU kernels' formulas
    (``repro/kernels/flash_attention.py`` ``flash_attention_bwd``), all
    in f32: q scaled before QK^T, ``p = where(mask, exp(s - lse), 0)``,
    ``delta = rowsum(do * o)``, ``ds = p * (dp - delta)``,
    ``dq = ds K * scale``, ``dk = ds^T (q * scale)``, ``dv = p^T do``, dk
    and dv summed over each GQA group. Returns (dq, dk, dv) in q's, k's
    and v's dtypes."""
    kw = dict(causal=causal, window=window)
    delta = attention_delta(o, do)
    return (flash_attention_dq_ref(q, k, v, do, lse, delta, **kw),
            *flash_attention_dkv_ref(q, k, v, do, lse, delta, **kw))


def rmsnorm_bwd_ref(x, scale, dy, eps: float = 1e-5):
    """Gradient of :func:`rmsnorm_ref` from its saved input: (dx in x's
    dtype, dscale f32). With r = rsqrt(mean(x^2) + eps) and g = dy*scale:
    dx = r*g - x * r^3 * mean(g*x), dscale = sum over rows of dy*x*r."""
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    g = dyf * scale
    dx = r * g - xf * r.pow(3) * (g * xf).mean(-1, keepdim=True)
    dscale = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale


# ------------------------------------------------------------------ wkv6
# Largest in-chunk decay magnitude -min(cumsum(ld)) for which the WKV6
# kernel takes the decay-rescaled product: its factors stay <= exp(30).
# The reference's constant (``repro/kernels/rwkv6.py:43``).
SAFE_DECAY_RANGE = 30.0


def linear_attention_step(state, q, k, v, ld, u=None):
    """One step of the decayed linear-attention recurrence. q, k, ld
    (B,H,K); v (B,H,V); state (B,H,K,V). Returns (state, o (B,H,V)).
    With u (rwkv6) the current token enters through the bonus u and the
    state after o; without (SSD) it enters the state before o."""
    kv = k[..., :, None] * v[..., None, :]
    if u is None:
        state = torch.exp(ld)[..., None] * state + kv
        o = torch.einsum("bhk,bhkv->bhv", q, state)
    else:
        o = (torch.einsum("bhk,bhkv->bhv", q, state)
             + torch.einsum("bhk,bhkv->bhv", q * u, kv))
        state = torch.exp(ld)[..., None] * state + kv
    return state, o


def recurrent_linear_attention(q, k, v, ld, u=None, initial_state=None):
    """The exact per-token recurrence over (B,T,H,*) inputs, in f32.
    Returns (o (B,T,H,V) f32, state (B,H,K,V))."""
    B, T, H, K = q.shape
    state = (initial_state if initial_state is not None else torch.zeros(
        (B, H, K, v.shape[-1]), dtype=torch.float32, device=q.device))
    qf, kf, vf, ldf = (a.float() for a in (q, k, v, ld))
    outs = []
    for t in range(T):
        state, o = linear_attention_step(state, qf[:, t], kf[:, t], vf[:, t],
                                         ldf[:, t], u)
        outs.append(o)
    return torch.stack(outs, 1), state


def wkv6_ref(q, k, v, ld, u=None):
    """The exact per-token recurrence (the reference's oracle,
    ``repro/kernels/ref.py::wkv6_ref``)."""
    return recurrent_linear_attention(q, k, v, ld, u)


def wkv6_fold_initial_state(o, state, q, ld, u, initial_state):
    """Folds a carried-in state S0 into a zero-state result (o, state) as
    the reference's wrapper does outside its kernel
    (``repro/kernels/ops.py::_wkv6_jit``): o += (q e^{p_exc}) S0 in o's
    dtype, state += e^{sum(ld)} S0, with p_exc the exclusive (rwkv6) or
    inclusive (SSD) cumulative log decay over the whole sequence."""
    f32 = torch.float32
    ldf = ld.to(f32)
    p = torch.cumsum(ldf, dim=1)
    if u is not None:
        p = p - ldf
    extra = torch.einsum("bthk,bhkv->bthv", q.to(f32) * torch.exp(p),
                         initial_state.to(f32))
    o = o + extra.to(o.dtype)
    total = torch.exp(ldf.sum(1))                                # (B,H,K)
    return o, state + total[..., None] * initial_state


def wkv6_chunked_ref(q, k, v, ld, u=None, initial_state=None, *,
                     chunk: int = 64):
    """Kernel B6's function, the chunked WKV6 of the reference's TPU
    kernel (``repro/kernels/rwkv6.py::_wkv_kernel`` with its entry point
    ``wkv6_fwd`` and wrapper ``ops.wkv6``).

    q, k, ld (B,T,H,K); v (B,T,H,V); u (H,K) f32 (rwkv6 mode: bonus on
    the current token, which does not see itself in the state) or None
    (SSD mode: the current token sees itself). Per chunk of ``chunk``
    tokens, in f32: p = cumsum(ld), w = p - ld (rwkv6) or p (SSD); the
    intra-chunk scores A[t,s] = sum_k q_tk k_sk e^{w_tk - p_sk} over s < t
    (rwkv6) or s <= t (SSD), as the rescaled product (q e^w)(k e^-p)^T
    where the chunk's decay range -min(p) is below SAFE_DECAY_RANGE and
    the exact per-pair exponent otherwise, chosen per (b, h, chunk) as
    the kernel does; o = A v [+ (q.u.k) v] + (q e^w) S, written in q's
    dtype; S <- e^{p_last} S + (k e^{p_last - p})^T v. Any T: the last
    chunk is padded with ld = 0 and k = 0, which leave the state as it
    is, and the padded rows of o are dropped. A nonzero initial_state is
    folded in afterwards (:func:`wkv6_fold_initial_state`). Returns
    (o (B,T,H,V) in q's dtype, state (B,H,K,V) f32)."""
    B, T, H, K = q.shape
    V = v.shape[-1]
    f32 = torch.float32
    c = max(1, min(chunk, T))
    pad = (-T) % c
    if pad:
        z = (0, 0, 0, 0, 0, pad)
        q, k, v, ld = (torch.nn.functional.pad(a, z) for a in (q, k, v, ld))
    idx = torch.arange(c, device=q.device)
    mask = (idx[:, None] > idx[None, :]) if u is not None else (
        idx[:, None] >= idx[None, :])                             # (t, s)
    S = torch.zeros((B, H, K, V), dtype=f32, device=q.device)
    outs = []
    for i in range(0, T + pad, c):
        qi, ki, vi, ldi = (a[:, i:i + c].to(f32) for a in (q, k, v, ld))
        p = torch.cumsum(ldi, dim=1)                              # (B,c,H,K)
        w = p - ldi if u is not None else p
        qe = qi * torch.exp(w)
        # e^-p clamped at the range bound: equal on the heads that take the
        # rescaled product, and finite (so its gradient too) on the others
        ke = ki * torch.exp(torch.clamp(-p, max=SAFE_DECAY_RANGE))
        a_mm = torch.einsum("bthk,bshk->bhts", qe, ke)
        diff = (w[:, :, None] - p[:, None, :]).masked_fill(
            ~mask[None, :, :, None, None], float("-inf"))     # (B,t,s,H,K)
        a_pw = torch.einsum("bthk,bshk,btshk->bhts", qi, ki, torch.exp(diff))
        safe = -p.amin(dim=(1, 3)) < SAFE_DECAY_RANGE             # (B,H)
        a = torch.where(safe[..., None, None],
                        a_mm.masked_fill(~mask, 0.0), a_pw)
        o = torch.einsum("bhts,bshv->bthv", a, vi)
        if u is not None:
            diag = torch.einsum("bthk,hk,bthk->bth", qi, u.to(f32), ki)
            o = o + diag[..., None] * vi
        o = o + torch.einsum("bthk,bhkv->bthv", qe, S)
        p_last = p[:, -1]                                         # (B,H,K)
        S = torch.exp(p_last)[..., None] * S + torch.einsum(
            "bthk,bthv->bhkv", ki * torch.exp(p_last[:, None] - p), vi)
        outs.append(o.to(q.dtype))
    o = torch.cat(outs, 1)[:, :T] if outs else torch.zeros(
        (B, 0, H, V), dtype=q.dtype, device=q.device)
    if initial_state is not None:
        o, S = wkv6_fold_initial_state(o, S, q[:, :T], ld[:, :T], u,
                                       initial_state)
    return o, S
