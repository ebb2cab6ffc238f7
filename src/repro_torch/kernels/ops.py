"""Checked entry points of the port's kernels, with launch counters.

Each wrapper validates device, dtype, shape and contiguity, then
dispatches on where its tensors lie: on the CPU it runs the kernel's plain
version (:mod:`repro_torch.kernels.ref`); on a CUDA device it launches the
hand-written kernel or raises. There is no fallback from a failed launch.

``flash_attention`` and ``rmsnorm`` are differentiable. Where autograd
needs a gradient they go through a ``torch.autograd.Function``, never
handing back a kernel's output without a ``grad_fn``: attention runs
kernel B2 (the forward that also writes the logsumexp rows) and, in the
backward, B3 (dq) and B4 (dk, dv); RMSNorm runs K3 forward and a plain
PyTorch backward from the saved input, as the JAX package has no RMSNorm
backward kernel. Without a gradient, attention runs K1.

``wkv6`` (kernel B6) is forward only, as in the reference, which has no
backward kernel for it: on CUDA tensors that require a gradient it
raises rather than return an output without a ``grad_fn``.

``paged_attention``, ``wkv6`` and ``rmsnorm`` take the launch parameter
their kernel opens (K2's ``splits``, B6's ``v_slice``, K3's ``threads``):
on a CUDA tensor it is resolved by :mod:`repro_torch.kernels.tuning`
(explicit > tuned cache > the heuristic's mirror) and passed to the C
launcher; an illegal explicit value raises ``ValueError``. On CPU tensors
the plain version runs and an explicit value is only validated.

``LAUNCHES`` counts kernel launches per kernel. A wrapper adds one where
it launches its kernel and nowhere else, so a run that resets the counts
before and reads them after shows which kernels its path went through.

Each wrapper also runs its kernel, or its plain version, inside
:func:`repro_torch.kernels.work.kernel`, which reports the kernel's own
operations and bytes to an active cost counter in place of the aten
operations issued inside it, on the CPU and the card alike.
"""
from __future__ import annotations

import torch

from repro_torch.core.spans import span
from repro_torch.kernels import ref, tuning, work

KERNELS = ("flash_attention", "flash_attention_lse", "flash_attention_dq",
           "flash_attention_dkv", "paged_attention", "rmsnorm", "wkv6")
LAUNCHES = dict.fromkeys(KERNELS, 0)
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _on_cuda(what: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones and for ``meta`` ones
    (shapes only: the dry run counts a kernel's work there, and its plain
    version computes nothing); raises on a mix or on any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev.type == "cuda"


def _require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _require_contiguous(what: str, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        _require(t.is_contiguous(), what, f"{name} must be contiguous")


def _require_aligned16(what: str, **tensors: torch.Tensor) -> None:
    """The attention kernels copy rows 16 bytes at a time (``cp.async``):
    a contiguous view at an odd storage offset would fault, so it is
    refused here, with no fallback."""
    for name, t in tensors.items():
        _require(t.data_ptr() % 16 == 0, what,
                 f"{name} must start on a 16-byte boundary")


def _dense(*tensors: torch.Tensor) -> tuple:
    """A plain version's outputs laid out as its kernel writes them
    (contiguous), so that what follows a wrapper runs, and counts, alike
    on every device."""
    return tuple(t.contiguous() for t in tensors)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FlashAttention(torch.autograd.Function):
    """Kernel B2 forward (saving q, k, v, o and lse), kernels B3 and B4
    backward; the plain versions of all three on CPU tensors. The
    counterpart of the JAX package's ``custom_vjp``
    (``repro/kernels/ops.py::_flash_attention``). Under
    ``torch.utils.checkpoint`` the forward runs again at the recompute."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        kw = dict(causal=causal, window=window)
        with work.kernel("flash_attention_lse",
                         lambda: work.flash_forward(q, k, lse=True, **kw)):
            if q.is_cuda:
                from repro_torch.kernels.flash_attention import (
                    flash_attention_lse_cuda)
                o, lse = flash_attention_lse_cuda(q, k, v, **kw)
                if o.numel():
                    LAUNCHES["flash_attention_lse"] += 1
            else:
                o, lse = _dense(*ref.flash_attention_lse_ref(q, k, v, **kw))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, window=ctx.window)
        do = do.to(q.dtype).contiguous()
        # delta = rowsum(dO * O) is plain PyTorch on both paths, outside
        # the kernels (the TPU wrapper computes it outside its kernels too)
        delta = ref.attention_delta(o, do)
        cuda = do.is_cuda
        if cuda:
            from repro_torch.kernels.flash_attention import (
                flash_attention_dkv_cuda, flash_attention_dq_cuda)
            _require_aligned16("flash_attention backward", do=do)
        with work.kernel("flash_attention_dq",
                         lambda: work.flash_dq(q, k, **kw)):
            if cuda:
                dq = flash_attention_dq_cuda(q, k, v, do, lse, delta, **kw)
                if dq.numel():
                    LAUNCHES["flash_attention_dq"] += 1
            else:
                dq, = _dense(ref.flash_attention_dq_ref(q, k, v, do, lse,
                                                        delta, **kw))
        with work.kernel("flash_attention_dkv",
                         lambda: work.flash_dkv(q, k, **kw)):
            if cuda:
                dk, dv = flash_attention_dkv_cuda(q, k, v, do, lse, delta,
                                                  **kw)
                if dk.numel():
                    LAUNCHES["flash_attention_dkv"] += 1
            else:
                dk, dv = _dense(*ref.flash_attention_dkv_ref(
                    q, k, v, do, lse, delta, **kw))
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Kernel K1, or B2 with B3 and B4 in the backward where autograd needs
    a gradient of q, k or v. q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D), Hq a
    multiple of Hkv, one dtype (f32 or bf16) -> (B,Sq,Hq,D). Any
    Sq/Sk."""
    with span("repro_torch.kernels.flash_attention"):
        what = "flash_attention"
        cuda = _on_cuda(what, q, k, v)
        _require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape, what,
                 f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                 f"v{tuple(v.shape)}")
        B, Sq, Hq, D = q.shape
        _require(k.shape[0] == B and k.shape[3] == D
                 and k.shape[2] > 0 and Hq % k.shape[2] == 0, what,
                 f"q{tuple(q.shape)} does not match k{tuple(k.shape)}")
        _require(q.dtype in _DTYPES and k.dtype == q.dtype == v.dtype, what,
                 f"dtypes {q.dtype}/{k.dtype}/{v.dtype}; need one of "
                 f"{_DTYPES}")
        _require(window >= 0, what, f"window must be >= 0, got {window}")
        if cuda:
            from repro_torch.kernels.flash_attention import HEAD_DIMS
            _require(D in HEAD_DIMS, what, f"head dim {D} not in {HEAD_DIMS}")
            _require_contiguous(what, q=q, k=k, v=v)
            _require_aligned16(what, q=q, k=k, v=v)
        if _needs_grad(q, k, v):
            return _FlashAttention.apply(q, k, v, causal, window)
        kw = dict(causal=causal, window=window)
        with work.kernel("flash_attention",
                         lambda: work.flash_forward(q, k, **kw)):
            if not cuda:
                return _dense(ref.flash_attention_ref(q, k, v, **kw))[0]
            from repro_torch.kernels.flash_attention import (
                flash_attention_cuda)
            out = flash_attention_cuda(q, k, v, **kw)
            # the C entry launches nothing for an empty output
            if out.numel():
                LAUNCHES["flash_attention"] += 1
            return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    splits=None) -> torch.Tensor:
    """Kernel K2. q (B,1,Hq,D); pools (P,ps,Hkv,D) of q's dtype;
    block_tables (B,n_pages) int32 physical page ids in logical order,
    padded with the null page 0; lengths (B,) int32 -> (B,1,Hq,D).
    ``splits``: the blocks (a thread-block cluster) sharing a row's live
    pages, 1 to 8, clamped to n_pages; None resolves it
    (:func:`tuning.resolve_paged_splits`)."""
    with span("repro_torch.kernels.paged_attention"):
        what = "paged_attention"
        cuda = _on_cuda(what, q, k_pages, v_pages, block_tables, lengths)
        _require(q.dim() == 4 and q.shape[1] == 1, what,
                 f"takes one query token per row, got q{tuple(q.shape)}")
        B, _, Hq, D = q.shape
        _require(k_pages.dim() == 4 and v_pages.shape == k_pages.shape
                 and k_pages.shape[3] == D and k_pages.shape[2] > 0
                 and Hq % k_pages.shape[2] == 0, what,
                 f"pools k{tuple(k_pages.shape)} v{tuple(v_pages.shape)} "
                 f"do not match q{tuple(q.shape)}")
        _require(block_tables.dim() == 2 and block_tables.shape[0] == B
                 and block_tables.shape[1] > 0 and lengths.shape == (B,), what,
                 f"block_tables{tuple(block_tables.shape)} / "
                 f"lengths{tuple(lengths.shape)} do not match batch {B}")
        _require(q.dtype in _DTYPES
                 and k_pages.dtype == q.dtype == v_pages.dtype,
                 what, f"dtypes {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
        _require(block_tables.dtype == torch.int32
                 and lengths.dtype == torch.int32,
                 what, "block_tables and lengths must be int32")
        counted = work.kernel("paged_attention", lambda: work.paged_decode(
            q, k_pages, lengths, k_pages.shape[1]))
        if splits is not None:
            tuning.check_splits(splits)
        if not cuda:
            with counted:
                return _dense(ref.paged_decode_attention_ref(
                    q, k_pages, v_pages, block_tables, lengths))[0]
        from repro_torch.kernels.paged_attention import (VEC,
                                                         paged_attention_cuda)
        _require(D % VEC == 0 and D <= 1024, what,
                 f"head dim {D} must be a multiple of {VEC}, at most 1024")
        _require_contiguous(what, q=q, k_pages=k_pages, v_pages=v_pages,
                            block_tables=block_tables, lengths=lengths)
        _require(all(t.data_ptr() % (VEC * t.element_size()) == 0
                     for t in (k_pages, v_pages)), what,
                 f"pools must start on a {VEC}-element boundary")
        splits = tuning.resolve_paged_splits(
            splits, q_shape=q.shape, pages_shape=k_pages.shape,
            n_pages=block_tables.shape[1], dtype=q.dtype)
        with counted:
            out = paged_attention_cuda(q, k_pages, v_pages, block_tables,
                                       lengths, splits)
            if out.numel():
                LAUNCHES["paged_attention"] += 1
        return out


def _rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float,
                 threads=None) -> torch.Tensor:
    d = x.shape[-1]
    rows = x.numel() // max(d, 1)
    with work.kernel("rmsnorm", lambda: work.rmsnorm(
            rows, d, x.element_size())):
        if not x.is_cuda:
            return _dense(ref.rmsnorm_ref(x, scale, eps))[0]
        from repro_torch.kernels.rmsnorm import rmsnorm_cuda
        threads = tuning.resolve_rmsnorm_threads(threads, rows=rows, d=d,
                                                 dtype=x.dtype)
        out = rmsnorm_cuda(x.view(-1, d), scale, eps, threads)
        if out.numel():
            LAUNCHES["rmsnorm"] += 1
        return out.view(x.shape)


class _RMSNorm(torch.autograd.Function):
    """Kernel K3 forward (its plain version on CPU tensors); the backward
    in plain PyTorch from the saved input (:func:`ref.rmsnorm_bwd_ref`)."""

    @staticmethod
    def forward(ctx, x, scale, eps, threads):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm_fwd(x, scale, eps, threads)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        return (*ref.rmsnorm_bwd_ref(x, scale, dy, ctx.eps), None, None)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5, threads=None) -> torch.Tensor:
    """Kernel K3, differentiable in x and scale. x (..., d) f32 or bf16;
    scale (d,) f32 -> x's shape and dtype. ``threads``: a row's block,
    whole warps from 32 to 512; None resolves it
    (:func:`tuning.resolve_rmsnorm_threads`)."""
    with span("repro_torch.kernels.rmsnorm"):
        what = "rmsnorm"
        cuda = _on_cuda(what, x, scale)
        _require(x.dim() >= 1 and scale.shape == (x.shape[-1],), what,
                 f"scale{tuple(scale.shape)} does not match x{tuple(x.shape)}")
        _require(x.dtype in _DTYPES and scale.dtype == torch.float32, what,
                 f"dtypes x {x.dtype} / scale {scale.dtype}")
        if threads is not None:
            tuning.check_threads(threads)
        if cuda:
            _require_contiguous(what, x=x, scale=scale)
        if _needs_grad(x, scale):
            return _RMSNorm.apply(x, scale, eps, threads)
        return _rmsnorm_fwd(x, scale, eps, threads)


def wkv6(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
         u=None, initial_state=None, *, v_slice=None) -> tuple:
    """Kernel B6, the chunked WKV6 (decayed linear attention with a carried
    state), chunks of 64 tokens. q, k, ld (B,T,H,K), any strides; v
    (B,T,H,V); q, k, v one dtype (f32 or bf16), ld f32 or bf16; u (H,K)
    f32 (rwkv6 mode) or None (SSD mode); initial_state (B,H,K,V) f32 or
    None. Any T; on CUDA, K and V at most 64. Returns (o (B,T,H,V) in q's
    dtype, state (B,H,K,V) f32), the contract of the reference's
    ``ops.wkv6``. A nonzero initial_state is folded in outside the kernel
    (:func:`ref.wkv6_fold_initial_state`), as the reference does.
    ``v_slice``: the V columns a block computes, 16, 32 or 64; None
    resolves it (:func:`tuning.resolve_wkv_v_slice`).

    Forward only: on CUDA tensors that require a gradient it raises (the
    reference has no backward kernel; train through the model's
    ``chunked`` ssm backend). On CPU tensors it runs the plain version,
    which autograd differentiates."""
    what = "wkv6"
    tensors = [t for t in (q, k, v, ld, u, initial_state) if t is not None]
    cuda = _on_cuda(what, *tensors)
    _require(q.dim() == 4 and k.shape == q.shape and ld.shape == q.shape
             and v.dim() == 4 and v.shape[:3] == q.shape[:3], what,
             f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
             f"v{tuple(v.shape)} ld{tuple(ld.shape)}")
    B, T, H, K = q.shape
    V = v.shape[-1]
    _require(q.dtype in _DTYPES and k.dtype == q.dtype == v.dtype
             and ld.dtype in _DTYPES, what,
             f"dtypes q/k/v {q.dtype}/{k.dtype}/{v.dtype}, ld {ld.dtype}; "
             f"need one of {_DTYPES}")
    _require(u is None or (u.shape == (H, K) and u.dtype == torch.float32),
             what, "u must be (H, K) float32 or None")
    _require(initial_state is None
             or (initial_state.shape == (B, H, K, V)
                 and initial_state.dtype == torch.float32), what,
             "initial_state must be (B, H, K, V) float32 or None")
    counted = work.kernel("wkv6", lambda: work.wkv6(q, v, ld, u))
    if v_slice is not None:
        tuning.check_v_slice(v_slice, K, q.element_size(),
                             ld.element_size())
    if not cuda:
        with counted:
            return _dense(*ref.wkv6_chunked_ref(q, k, v, ld, u,
                                                initial_state))
    _require(not _needs_grad(*tensors), what,
             "no backward kernel: the reference has none, and an output "
             "without a grad_fn would drop the gradient; use the chunked "
             "ssm backend to train")
    from repro_torch.kernels.wkv6 import MAX_DIM, wkv6_cuda
    _require(0 < K <= MAX_DIM and 0 < V <= MAX_DIM, what,
             f"K={K}, V={V}: the kernel takes 1..{MAX_DIM}")
    if u is not None:
        _require_contiguous(what, u=u)
    with counted:
        if B * H * T == 0:
            o = torch.zeros((B, T, H, V), dtype=q.dtype, device=q.device)
            state = torch.zeros((B, H, K, V), dtype=torch.float32,
                                device=q.device)
        else:
            v_slice = tuning.resolve_wkv_v_slice(
                v_slice, q_shape=q.shape, v_head=V, dtype=q.dtype,
                use_u=u is not None, ld_dtype=ld.dtype)
            o, state = wkv6_cuda(q, k, v, ld, u, v_slice)
            LAUNCHES["wkv6"] += 1
        if initial_state is not None:
            o, state = ref.wkv6_fold_initial_state(o, state, q, ld, u,
                                                   initial_state)
    return o, state
