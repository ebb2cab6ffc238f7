"""Deterministic synthetic workloads, copied from ``repro/data/pipeline.py``
(numpy only): the same seed gives the same training batches, prompts and
arrival times, byte for byte, in both packages."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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


@dataclass
class SyntheticLM:
    """Next-token training batches of Zipf documents separated by EOS
    (id 0), for the token-input (dense) family. ``batch_at(step)`` is
    deterministic in (seed, step, row), so a restarted run sees the same
    data. Tensors land on ``device``."""
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    mean_doc_len: int = 512
    device: str = "cuda"

    def __post_init__(self):
        if self.cfg.frontend != "none":
            raise NotImplementedError(
                f"{self.cfg.name}: the {self.cfg.frontend!r} frontend's "
                "batches come with the other families (ROADMAP.md A.4)")

    def batch_at(self, step: int, shard: int = 0,
                 num_shards: int = 1) -> dict:
        """Deterministic batch for ``step``; only rows of ``shard`` are
        built. {"tokens", "labels"}: (rows, seq) int32."""
        if self.batch % num_shards:
            raise ValueError(
                f"batch={self.batch} must divide evenly over "
                f"num_shards={num_shards}")
        rows_per = self.batch // num_shards
        out = np.empty((rows_per, self.seq + 1), np.int32)
        for r in range(rows_per):
            row_global = shard * rows_per + r
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 100_003 + row_global)
            buf = []
            while sum(len(b) for b in buf) < self.seq + 1:
                n = max(8, int(rng.exponential(self.mean_doc_len)))
                buf.append(_doc_tokens(rng, self.cfg.vocab_size, n))
                buf.append(np.zeros(1, np.int64))   # EOS
            out[r] = np.concatenate(buf)[: self.seq + 1]
        out = torch.from_numpy(out).to(self.device)
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}
