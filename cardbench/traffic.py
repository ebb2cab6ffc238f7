"""The one general generator of every traffic mix: training batches and an
open-loop request stream, from a mix's parameters and the run's seed.

The Zipf document sampler and the packing of documents into training
rows are copies of the port's ``data/pipeline.py`` (``_doc_tokens``,
``SyntheticLM.batch_at``), frozen here so that the yardstick does not move
with the program.

Requests are drawn so that every seed gives the same work: the prompt and
output lengths are the quantiles of their clipped lognormals at
(i + 1/2) / n and the gaps between arrivals those of the exponential, put
in an order that the mix's ``schedule_seed`` fixes; the run's seed writes
the tokens. With the order drawn from the run's seed, where long prompts
meet in a burst moved the 80th percentile of 64 requests' time to first
token by 13% between seeds, more than a bound can hold.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

SEED_MOD = 2 ** 63


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any whole number) and a stream."""
    return np.random.default_rng([int(seed) % SEED_MOD, *stream])


def doc_tokens(g: np.random.Generator, vocab: int, length: int,
               zipf_a: float = 1.3) -> np.ndarray:
    """A Zipf-distributed token stream of ``length`` ids in [1, vocab - 2]
    (id 0 is the end of a document)."""
    toks = g.zipf(zipf_a, size=length).astype(np.int64)
    return (toks % max(vocab - 2, 1)) + 1


def packed_rows(seed: int, step: int, rows: int, seq: int, vocab: int,
                mean_doc_len: int, zipf_a: float) -> np.ndarray:
    """(rows, seq + 1) int32 rows of Zipf documents separated by id 0, each
    row from its own stream of (seed, step, row): rows of every step differ."""
    out = np.empty((rows, seq + 1), np.int32)
    for r in range(rows):
        g = rng(seed, 1, step, r)
        buf, n = [], 0
        while n < seq + 1:
            length = max(8, int(g.exponential(mean_doc_len)))
            buf.append(doc_tokens(g, vocab, length, zipf_a))
            buf.append(np.zeros(1, np.int64))
            n += length + 1
        out[r] = np.concatenate(buf)[: seq + 1]
    return out


def lognormal_quantiles(n: int, median: float, sigma: float, lo: int,
                        hi: int) -> np.ndarray:
    """The n quantiles at (i + 1/2) / n of a lognormal clipped to
    [lo, hi], as whole numbers."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    vals = np.exp(math.log(median) + sigma * z)
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def exponential_gaps(n: int, seconds: float) -> np.ndarray:
    """n gaps: the quantiles at (i + 1/2) / n of an exponential, scaled so
    that they add up to ``seconds``."""
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u)
    return gaps * (seconds / gaps.sum())


@dataclass(frozen=True)
class Arrival:
    rid: int
    prompt: np.ndarray       # (prompt_len,) int32
    max_new_tokens: int
    arrival_s: float         # when it is due, from the start of the window


def open_loop(seed: int, seconds: float, mix: dict, vocab: int) -> list:
    """The requests of an open loop at ``mix["rate_per_s"]`` over
    ``seconds``: round(rate x seconds) of them, due from 0 to before
    ``seconds``, in order of arrival; their sizes and arrivals are the
    mix's, their tokens the seed's."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    p, o = mix["prompt"], mix["output"]
    plens = lognormal_quantiles(n, p["median"], p["sigma"], p["min"], p["max"])
    olens = lognormal_quantiles(n, o["median"], o["sigma"], o["min"], o["max"])
    g = rng(mix["schedule_seed"], 2)
    plens, olens = g.permutation(plens), g.permutation(olens)
    gaps = g.permutation(exponential_gaps(n, seconds))
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    out = []
    for i in range(n):
        toks = doc_tokens(rng(seed, 3, i), vocab, int(plens[i]),
                          mix.get("zipf_a", 1.3)).astype(np.int32)
        out.append(Arrival(rid=i, prompt=toks, max_new_tokens=int(olens[i]),
                           arrival_s=float(due[i])))
    return out
