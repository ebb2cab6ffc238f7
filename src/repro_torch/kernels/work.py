"""The work of each hand-written kernel: operations and bytes per call.

One function per kernel computes, from the call's shapes (and, for B6 and
K2, from the data that decides how much work the kernel does), the
operations the kernel's function needs and the bytes it must move: each
input read once and each output written once. ``chip_smoke.py`` divides
them by the card's peaks for a kernel's bound; the cost counter
(:func:`repro_torch.core.cost.count_cost`) adds them up for a whole step.

A kernel launched through ``ctypes`` is invisible to a dispatch mode, and
on the CPU the wrappers run plain versions whose operations are another
count. So each wrapper in :mod:`repro_torch.kernels.ops` runs its kernel
(or plain version) inside :func:`kernel`, which reports the kernel's own
work to every active counter and marks the region, so that the counter
ignores the aten operations issued inside it. The CPU and the card then
count the same thing.
"""
from __future__ import annotations

import functools
import threading
from contextlib import contextmanager
from typing import Callable, List, NamedTuple


class Work(NamedTuple):
    flops: float
    bytes: float


# counters (core.cost) that receive the kernels' work, process-wide: the
# autograd engine runs a CUDA backward on a thread of its own
_COUNTERS: List = []
_REGION = threading.local()


def inside_kernel() -> bool:
    """True while this thread runs a wrapper's kernel or plain version."""
    return getattr(_REGION, "depth", 0) > 0


def inside_collective() -> bool:
    """True while this thread runs a ``torch.distributed`` call
    (:func:`collective`)."""
    return getattr(_REGION, "collective", 0) > 0


@contextmanager
def collective():
    """Run one ``torch.distributed`` call inside: a counter counts its
    ``c10d`` operation, and not the aten operations its backend runs
    around it (gloo's copies as it waits; NCCL and the dry run's ``fake``
    group run none), so every backend counts alike."""
    _REGION.collective = getattr(_REGION, "collective", 0) + 1
    try:
        yield
    finally:
        _REGION.collective -= 1


@contextmanager
def kernel(name: str, work: Callable[[], Work]):
    """Run a kernel's call inside; on success, report ``work()`` (computed
    inside the region, so its own operations are not counted) as one call
    of ``name`` to every active counter. A call with no work (an empty
    output, which launches nothing) is not reported."""
    if not _COUNTERS:
        yield
        return
    _REGION.depth = getattr(_REGION, "depth", 0) + 1
    try:
        yield
        w = work()
    finally:
        _REGION.depth -= 1
    if w.flops or w.bytes:
        for counter in list(_COUNTERS):
            counter.add_kernel(name, w)


# ------------------------------------------------------------ attention
@functools.lru_cache(maxsize=None)
def attention_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask keeps, per batch row and head: key j
    for query i where j <= i (causal) and i - j < window (window > 0),
    as ``ref.dense_attention`` masks them (positions from 0 on both
    sides)."""
    total = 0
    for i in range(sq):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def _attention_shapes(q, k):
    B, Sq, Hq, D = q.shape
    return B, Sq, k.shape[1], Hq, k.shape[2], D, q.element_size()


def flash_forward(q, k, *, causal: bool, window: int,
                  lse: bool = False) -> Work:
    """K1 (``lse=False``) or B2: QK^T and PV over the kept pairs, two
    products of D multiply-adds each; reads q, k, v, writes o (and B2's
    f32 logsumexp rows)."""
    B, Sq, Sk, Hq, Hkv, D, isz = _attention_shapes(q, k)
    pairs = B * Hq * attention_pairs(Sq, Sk, causal, window)
    nbytes = isz * B * D * (2 * Sq * Hq + 2 * Sk * Hkv)
    return Work(4 * D * pairs, nbytes + (4 * B * Hq * Sq if lse else 0))


def flash_dq(q, k, *, causal: bool, window: int) -> Work:
    """B3: QK^T, dO V^T and dS K over the kept pairs; reads q, k, v, dO,
    lse and delta, writes dq."""
    B, Sq, Sk, Hq, Hkv, D, isz = _attention_shapes(q, k)
    pairs = B * Hq * attention_pairs(Sq, Sk, causal, window)
    nbytes = (isz * B * D * (3 * Sq * Hq + 2 * Sk * Hkv)
              + 2 * 4 * B * Hq * Sq)
    return Work(6 * D * pairs, nbytes)


def flash_dkv(q, k, *, causal: bool, window: int) -> Work:
    """B4: QK^T, dO V^T, P^T dO and dS^T Q over the kept pairs; reads q, k,
    v, dO, lse and delta, writes dk and dv."""
    B, Sq, Sk, Hq, Hkv, D, isz = _attention_shapes(q, k)
    pairs = B * Hq * attention_pairs(Sq, Sk, causal, window)
    nbytes = (isz * B * D * (2 * Sq * Hq + 4 * Sk * Hkv)
              + 2 * 4 * B * Hq * Sq)
    return Work(8 * D * pairs, nbytes)


def paged_decode(q, k_pages, lengths, page_size: int) -> Work:
    """K2: one query token per row against its live tokens (QK^T and PV);
    reads q, the live tokens' k and v and the live table entries and
    lengths, writes o."""
    B, _, Hq, D = q.shape
    Hkv, isz = k_pages.shape[2], q.element_size()
    ntok = int(lengths.sum())
    live = int(((lengths + page_size - 1) // page_size).sum())
    return Work(4 * Hq * D * ntok,
                isz * (2 * ntok * Hkv * D + 2 * B * Hq * D)
                + 4 * (live + B))


# -------------------------------------------------------------- rmsnorm
def rmsnorm(rows: int, d: int, itemsize: int) -> Work:
    """K3: square, sum, scale and multiply per element; reads x and the
    f32 scale, writes the output."""
    return Work(4 * rows * d, 2 * itemsize * rows * d + 4 * d)


# ----------------------------------------------------------------- wkv6
WKV6_CHUNK = 64
WKV6_RANGE = 30.0    # a chunk past this decay range takes the per-pair path


def wkv6_rescaled(ld, T: int):
    """(B, chunks, H) 1.0 where B6 computes a chunk's scores as a rescaled
    product, 0.0 where it takes the exact per-pair path (decay range past
    ``WKV6_RANGE``). On ``meta`` (the dry run: no decays to read) every
    chunk counts as rescaled, the branch of the fewer operations."""
    import torch
    import torch.nn.functional as F
    B, _, H, K = ld.shape
    c = WKV6_CHUNK
    nc = -(-T // c)
    if ld.device.type == "meta":
        return torch.ones((B, nc, H))
    p = torch.cumsum(F.pad(ld.float(), (0, 0, 0, 0, 0, nc * c - T))
                     .reshape(B, nc, c, H, K), dim=2)
    return (-p.amin(dim=(2, 4)) < WKV6_RANGE).float()


def wkv6(q, v, ld, u) -> Work:
    """B6 on these inputs: each input read once (ld's broadcast view
    counts its storage), o and the state written once; operations as
    this run's decays need them, per (b, h, chunk): the kept score pairs
    times K (a multiply-add on the rescaled branch plus two scaled inputs
    per token and column; a subtraction, an exponential, a product and a
    multiply-add per pair and column on the per-pair path), A v over the
    kept pairs, (q e^w) S and the state update (c K V each), and rwkv6's
    diagonal (``u`` given)."""
    import torch
    B, T, H, K = q.shape
    V = v.shape[-1]
    c = WKV6_CHUNK
    nc = -(-T // c)
    safe = wkv6_rescaled(ld, T)                           # (B, nc, H)
    n = torch.full((nc, 1), float(c), device=safe.device)  # tokens a chunk
    n[-1] = T - (nc - 1) * c
    pairs = n * (n - 1) / 2 if u is not None else n * (n + 1) / 2
    per_chunk = 2 * pairs * V + 4 * n * K * V + (
        2 * n * (K + V) if u is not None else 0)
    scores_mm = 2 * pairs * K + 4 * n * K
    scores_pw = 5 * pairs * K
    flops = float((safe * (per_chunk + scores_mm)).sum()
                  + ((1 - safe) * (per_chunk + scores_pw)).sum())
    isz = q.element_size()
    ld_elems = 1
    for size, stride in zip(ld.shape, ld.stride()):
        ld_elems *= size if stride else 1
    nbytes = (isz * B * T * H * (2 * K + V) + ld.element_size() * ld_elems
              + (4 * H * K if u is not None else 0)
              + isz * B * T * H * V + 4 * B * H * K * V)
    return Work(flops, nbytes)
