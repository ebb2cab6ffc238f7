"""Batched serving loop: prefill once, decode tokens lockstep.

The PyTorch counterpart of ``repro/runtime/serve_loop.py``: the *lockstep
special case* of the request-level schedulers in
:mod:`repro_torch.serving`, with one synchronous batch in which every row
decodes the same number of tokens. Request-level serving (continuous
batching, per-request TTFT/latency metrics, EOS termination) lives in
``repro_torch.serving``; ``generate`` is the thin throughput-oriented
convenience API (callables and one batch dict in, tokens out) and keeps
the legacy ``(params, batch)`` prefill closures working.
"""
from __future__ import annotations

import inspect
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.serving.engine import (_generator, _sample_tokens,
                                        decode_lockstep)
from repro_torch.serving.roles import sync


def _accepts_cache_span(prefill: Callable) -> bool:
    """Whether ``prefill`` takes the 3-arg ``(params, batch, cache_span)``
    contract. Dispatch is by signature: a try/except on TypeError would
    swallow real TypeErrors raised *inside* a 3-arg prefill and run it
    twice."""
    try:
        sig = inspect.signature(prefill)
    except (TypeError, ValueError):
        return True              # uninspectable: assume the new contract
    n_pos = 0
    for p in sig.parameters.values():
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            return True
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD):
            n_pos += 1
    return n_pos >= 3


@dataclass
class ServeResult:
    tokens: np.ndarray           # (B, max_new_tokens)
    prefill_s: float
    decode_s: float
    tokens_per_s: float
    # tokens each row actually generated: max_new_tokens, or less when
    # eos_id terminated the row early (trailing tokens are dead weight the
    # lockstep batch still decoded, and paid for in time, but they are NOT
    # counted as throughput)
    new_tokens: Optional[np.ndarray] = None

    @property
    def total_new_tokens(self) -> int:
        if self.new_tokens is None:
            return int(np.prod(self.tokens.shape))
        return int(self.new_tokens.sum())


def generate(prefill: Callable, decode_step: Callable, params, batch: dict,
             *, prompt_len: int, max_new_tokens: int,
             cache_span: Optional[int] = None, eos_id: Optional[int] = None,
             greedy: bool = True, seed: int = 0) -> ServeResult:
    """Prefill ``batch`` then decode ``max_new_tokens`` lockstep tokens.

    ``prefill(params, batch, cache_span)`` sizes the decode cache
    (callables with the legacy two-arg ``(params, batch)`` signature still
    work). Sampling (``greedy=False``) applies to *every* token including
    the first, from a ``torch.Generator`` seeded with ``seed``; tokens
    accumulate on the device with one host transfer after the loop.

    ``max_new_tokens`` must be >= 1. At exactly 1 the first
    (prefill-sampled) token is the whole output: no decode step runs and
    ``decode_s`` is 0. ``tokens_per_s`` counts tokens actually generated:
    rows that hit ``eos_id`` early contribute only their live prefix.
    """
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    # this lockstep convenience API *measures* wall time by design — it
    # never runs under a SimClock, hence the RS104 pragmas below
    span = cache_span or (prompt_len + max_new_tokens)
    t0 = time.perf_counter()  # repro: allow=RS104
    if _accepts_cache_span(prefill):
        logits, caches = prefill(params, batch, span)
    else:                        # legacy prefill(params, batch) closure
        logits, caches = prefill(params, batch)
    sync(logits.device)
    prefill_s = time.perf_counter() - t0  # repro: allow=RS104
    gen = None if greedy else _generator(logits.device, seed)
    tok = _sample_tokens(logits[:, -1:], gen, greedy)
    if max_new_tokens == 1:      # no decode phase: prefill made the token
        toks, decode_s = tok.cpu().numpy(), 0.0
    else:
        t0 = time.perf_counter()  # repro: allow=RS104
        toks, caches, _ = decode_lockstep(
            decode_step, params, caches, tok, start_pos=prompt_len,
            steps=max_new_tokens - 1, greedy=greedy, gen=gen)
        decode_s = time.perf_counter() - t0  # repro: allow=RS104
    new_tokens = np.full(toks.shape[0], max_new_tokens, np.int64)
    if eos_id is not None:
        hit = toks == eos_id
        new_tokens = np.where(hit.any(axis=1),
                              hit.argmax(axis=1) + 1, new_tokens)
    return ServeResult(tokens=toks, prefill_s=prefill_s, decode_s=decode_s,
                       tokens_per_s=int(new_tokens.sum()) / max(
                           prefill_s + decode_s, 1e-9),
                       new_tokens=new_tokens)
