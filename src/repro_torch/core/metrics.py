"""DABench-LLM Tier-1 metrics, the paper's equations (section IV.B), copied
from ``repro/core/metrics.py`` (the port imports nothing of the JAX
package):

  Eq.1  U = R_used / R_all                       (resource allocation ratio)
  Eq.2  U = sum L_i (R_i/R_all) / sum L_i        (runtime-weighted, sections)
  Eq.3  LI = (1/sum R_i) sum (T_min/T_i) R_i     (load imbalance; 1 = balanced)
  Eq.4  LI_total = sum L_i LI_i / sum L_i        (runtime-weighted, sections)
  Eq.5  AI = 6 P B S / (4 P + activation_mem)    (arithmetic intensity, train)

plus the card's reading of Eq. 5 (the ridge point of a
:class:`~repro_torch.core.roofline.Chip`), the tile-padding
efficiency of Hopper's ``mma.sync`` shapes (the stand-in for the paper's
PEs assigned but idle), and the sample statistics the serving report
needs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.roofline import H100, Chip


# ----------------------------------------------------------------- Eq. 1/2
def allocation_ratio(r_used: float, r_all: float) -> float:
    return r_used / r_all if r_all else 0.0


def weighted_allocation(sections: Sequence[tuple]) -> float:
    """sections: [(runtime_L_i, r_used_i, r_all_i)] -> Eq. 2."""
    num = sum(L * (r / ra if ra else 0.0) for L, r, ra in sections)
    den = sum(L for L, _, _ in sections)
    return num / den if den else 0.0


# ----------------------------------------------------------------- Eq. 3/4
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


def weighted_load_imbalance(sections: Sequence[tuple]) -> float:
    """sections: [(runtime_L_i, LI_i)] -> Eq. 4."""
    num = sum(L * li for L, li in sections)
    den = sum(L for L, _ in sections)
    return num / den if den else 1.0


# ------------------------------------------------------------------- Eq. 5
def arithmetic_intensity(params: float, batch: float, seq: float,
                         activation_bytes: float,
                         param_bytes_per: float = 4.0) -> float:
    """Paper Eq. 5 (training): 6PBS flops over (4P + activations) bytes."""
    denom = param_bytes_per * params + activation_bytes
    return 6.0 * params * batch * seq / denom if denom else 0.0


def activation_bytes_estimate(num_layers: int, batch: float, seq: float,
                              d_model: int, bytes_per: float = 2.0,
                              tensors_per_layer: float = 8.0) -> float:
    """Rough per-step activation traffic used by Eq. 5's denominator."""
    return num_layers * tensors_per_layer * batch * seq * d_model * bytes_per


def ridge_intensity(dtype: str = "float32", chip: Chip = H100) -> float:
    """FLOP per byte at which ``chip``'s peak for ``dtype`` meets its
    memory rate: an Eq. 5 intensity below it is memory-bound."""
    return chip.peak(dtype) / chip.hbm_bw


# ---------------------------------------------------------------- samples
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


# ------------------------------------------------ card-adapted allocation
def mma_tile_efficiency(m: int, n: int, k: int,
                        tile: Optional[Tuple[int, ...]] = None,
                        dtype: str = "float32", chip: Chip = H100) -> float:
    """Fraction of the matrix units' work that is useful for an (m,k)x(k,n)
    product after padding every dim to the hardware tile: the card's
    analogue of 'PEs assigned but idle'. ``tile`` defaults to ``chip``'s
    tile for ``dtype`` (Hopper's ``mma.sync``: m16n8k8 for TF32, which
    the port's f32 kernels run as 3xTF32, and m16n8k16 for bf16). A tile
    of three entries pads (m, n, k); one of two, (rows, lanes), pads m to
    rows and both n and k to lanes, as a systolic array's square tile
    does."""
    tile = tuple(tile or chip.mma_tile(dtype))
    if len(tile) == 2:
        tile = (tile[0], tile[1], tile[1])

    def pad(x, t):
        return -(-x // t) * t
    useful = m * n * k
    padded = pad(m, tile[0]) * pad(n, tile[1]) * pad(k, tile[2])
    return useful / padded if padded else 0.0


@dataclass
class TaskStat:
    """One paper 'task' (kernel/section): resources + throughput."""
    name: str
    resources: float          # devices (x unit share) assigned
    throughput: float         # work/s
    runtime: float = 0.0


def li_over_tasks(tasks: Iterable[TaskStat]) -> float:
    tasks = list(tasks)
    return load_imbalance([t.resources for t in tasks],
                          [t.throughput for t in tasks])


def slot_load_balance(slot_tokens) -> float:
    """Eq. 3 specialization for serving KV slots: each slot is one unit
    of resource, throughput_i = tokens served by slot i. 1.0 = every slot
    carried equal work; ->0 = a slot sat (mostly) idle."""
    tokens = np.asarray(slot_tokens, dtype=np.float64)
    if tokens.size == 0:
        return 1.0
    return load_imbalance(np.ones_like(tokens), tokens)


def expert_load_imbalance(expert_load: np.ndarray) -> float:
    """Eq. 3 specialization for MoE expert loads (tokens per expert):
    resources are equal (one expert = one unit); the MORE loaded experts
    are the bottleneck, so throughput_i = 1/load_i. An idle expert takes
    the largest throughput of the others."""
    load = np.asarray(expert_load, dtype=np.float64)
    load = np.where(load <= 0, np.nan, load)
    if np.all(np.isnan(load)):
        return 1.0
    inv = 1.0 / load
    inv = np.where(np.isnan(inv), np.nanmax(inv), inv)
    return load_imbalance(np.ones_like(inv), inv)
