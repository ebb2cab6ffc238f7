"""Deterministic synthetic workloads, copied from ``repro/data/pipeline.py``
(numpy only): the same seed gives the same training batches, prompts,
sessions and arrival times, byte for byte, in both packages."""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.frontends import bf16_from_numpy
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


def synth_sessions(cfg: ModelConfig, num_sessions: int, turns: int, *,
                   system_len: int = 32, turn_len: int = 16,
                   max_new_tokens: int = 16, rate_per_s: float = 0.0,
                   think_s: float = 0.0, stagger_s: float = 0.0,
                   seed: int = 0) -> list:
    """Deterministic multi-turn chat sessions for the prefix-cache story.

    Every session shares one ``system_len``-token system prompt; turn
    ``t`` of a session arrives with the *accumulated history* — system
    prompt plus user turns ``0..t`` (``turn_len`` fresh tokens each) —
    exactly the replay pattern a stateless chat API produces. Turn
    ``t``'s prompt therefore extends turn ``t-1``'s prompt, so a
    prefix-sharing engine re-prefills only the newest turn while a cold
    engine re-pays the whole history every time.

    Session starts are Poisson at ``rate_per_s`` (<=0: all at t=0),
    shifted by a deterministic ``stagger_s`` gap between consecutive
    sessions (the SimClock scenarios use the stagger instead of random
    arrivals so latency orderings stay schedule-determined); within a
    session, turn ``t`` arrives ``think_s`` seconds after turn ``t-1``
    (user think time). Request ids encode ``session * 100 + turn`` so
    reports can split warm/cold by turn. The returned list is sorted by
    arrival time, as the engines expect.
    """
    rng = np.random.default_rng(seed * 48_271 + 11)
    system = _doc_tokens(rng, cfg.vocab_size, system_len).astype(np.int32)
    starts = poisson_arrivals(num_sessions, rate_per_s,
                              seed=seed * 9176 + 7)
    starts = starts + np.arange(num_sessions) * stagger_s
    out = []
    for s in range(num_sessions):
        srng = np.random.default_rng(seed * 1_000_003 + 31 * s + 17)
        history = system
        for t in range(turns):
            user = _doc_tokens(srng, cfg.vocab_size, turn_len
                               ).astype(np.int32)
            history = np.concatenate([history, user])
            out.append(Request(rid=s * 100 + t, prompt=history.copy(),
                               max_new_tokens=max_new_tokens,
                               arrival_s=float(starts[s]) + t * think_s))
    out.sort(key=lambda r: (r.arrival_s, r.rid))
    return out


@dataclass
class SyntheticLM:
    """Next-token training batches of Zipf documents separated by EOS
    (id 0). ``batch_at(step)`` is deterministic in (seed, step, row), so
    a restarted run sees the same data. A frontend stub's batch carries
    its embeddings as the reference builds them: the vision stub's
    ``embeds`` (and M-RoPE ``positions``) in place of ``tokens``, the
    audio stub's ``audio_embeds`` beside them. Tensors land on
    ``device``."""
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    mean_doc_len: int = 512
    device: str = "cuda"

    def batch_at(self, step: int, shard: int = 0,
                 num_shards: int = 1) -> dict:
        """Deterministic batch for ``step``; only rows of ``shard`` are
        built. {"tokens", "labels"}: (rows, seq) int32; the vision stub's
        {"embeds": (rows, seq, d) bf16, "positions": (rows, 3, seq) int32
        (M-RoPE only), "labels"}; the audio stub's {"audio_embeds": (rows,
        seq, d) bf16, "tokens", "labels"}. The embeddings are N(0, 0.02^2)
        from ``default_rng(seed * 7 + step)``, for every shard alike, as
        in the reference."""
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
        batch = {"tokens": out[:, :-1], "labels": out[:, 1:]}
        frontend = self.cfg.frontend
        if frontend in ("vision_stub", "audio_stub"):
            rng = np.random.default_rng(self.seed * 7 + step)
            embeds = bf16_from_numpy(rng.standard_normal(
                (rows_per, self.seq, self.cfg.d_model)) * 0.02).to(
                self.device)
        if frontend == "vision_stub":
            batch["embeds"] = embeds
            if self.cfg.rope == "mrope":
                batch["positions"] = torch.arange(
                    self.seq, dtype=torch.int32, device=self.device)[
                    None, None].expand(rows_per, 3, self.seq)
            del batch["tokens"]
        elif frontend == "audio_stub":
            batch["audio_embeds"] = embeds
        return batch

    def iterate(self, start_step: int = 0, prefetch: int = 2,
                shard: int = 0, num_shards: int = 1) -> Iterator[dict]:
        """Prefetching iterator (producer thread + bounded queue), as the
        reference's. ``shard``/``num_shards`` reach :meth:`batch_at`, so
        a data-parallel host builds only its rows. Each step's batch is
        built exactly once (a full queue blocks the producer on ``put``),
        and closing the generator joins the producer thread."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                item = self.batch_at(step, shard=shard,
                                     num_shards=num_shards)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        step += 1
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            # unblock a producer stuck on a full queue, then join it
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:   # the producer may race the drain
                    break
            t.join(timeout=5.0)
