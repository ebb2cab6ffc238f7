"""The sample statistics the serving report needs, copied from
``repro/core/metrics.py`` (the port imports nothing of the JAX package):
Eq. 3 load imbalance, its serving-slot specialization, and the
percentile of a sorted sample list."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def load_imbalance(resources: Sequence[float],
                   throughputs: Sequence[float]) -> float:
    """Eq. 3. 1.0 = perfectly balanced; ->0 = one task starves the rest."""
    r = np.asarray(resources, dtype=np.float64)
    t = np.asarray(throughputs, dtype=np.float64)
    if r.size == 0 or r.sum() == 0:
        return 1.0
    t_min = t.min()
    if t_min <= 0:
        return 0.0
    return float((t_min / t * r).sum() / r.sum())


def percentile(sorted_samples: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile of an already-sorted sample list.
    Empty input -> 0.0."""
    if not sorted_samples:
        return 0.0
    pos = (len(sorted_samples) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(sorted_samples) - 1)
    return sorted_samples[lo] + (sorted_samples[hi] - sorted_samples[lo]) \
        * (pos - lo)


def slot_load_balance(slot_tokens) -> float:
    """Eq. 3 specialization for serving KV slots: each slot is one unit
    of resource, throughput_i = tokens served by slot i. 1.0 = every slot
    carried equal work; ->0 = a slot sat (mostly) idle."""
    tokens = np.asarray(slot_tokens, dtype=np.float64)
    if tokens.size == 0:
        return 1.0
    return load_imbalance(np.ones_like(tokens), tokens)
