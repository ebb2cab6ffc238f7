"""Deterministic synthetic serving workloads, copied from
``repro/data/pipeline.py`` (numpy only): the same seed gives the same
prompts and arrival times, byte for byte, in both packages."""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.request import Request


def _doc_tokens(rng: np.random.Generator, vocab: int, length: int,
                zipf_a: float = 1.3) -> np.ndarray:
    """Zipf-ish token stream (closer to text statistics than uniform)."""
    toks = rng.zipf(zipf_a, size=length).astype(np.int64)
    return (toks % max(vocab - 2, 1)) + 1        # reserve 0=EOS


def poisson_arrivals(n: int, rate_per_s: float, seed: int = 0) -> np.ndarray:
    """Cumulative arrival times (seconds) of a Poisson process at
    ``rate_per_s`` requests/s. ``rate_per_s <= 0`` means a burst: every
    request at t=0."""
    if n <= 0:
        return np.zeros(0, np.float64)
    if rate_per_s <= 0:
        return np.zeros(n, np.float64)
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_per_s, size=n))


def synth_requests(cfg: ModelConfig, n: int, prompt_len: int, *,
                   max_new_tokens=16, rate_per_s: float = 0.0,
                   seed: int = 0) -> list:
    """Deterministic synthetic request stream for the serving engines.

    Prompts come from the Zipf document sampler (EOS id 0 never appears
    in a prompt). ``max_new_tokens`` may be an int or a sequence cycled
    across requests. Arrivals are Poisson at ``rate_per_s`` (<=0 for a
    burst at t=0)."""
    budgets = ([int(max_new_tokens)] if np.isscalar(max_new_tokens)
               else [int(b) for b in max_new_tokens])
    arrivals = poisson_arrivals(n, rate_per_s, seed=seed * 9176 + 1)
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed * 1_000_003 + i)
        prompt = _doc_tokens(rng, cfg.vocab_size, prompt_len
                             ).astype(np.int32)
        out.append(Request(rid=i, prompt=prompt,
                           max_new_tokens=budgets[i % len(budgets)],
                           arrival_s=float(arrivals[i])))
    return out
