"""Tier-2: inter-chip scalability + deployment optimization (§IV.C / §VI).

Two complementary modes, mirroring the paper's methodology:

* ``scaling_table``  — analytic: roofline terms of one cell across mesh
  splits (DP-heavy ... TP-heavy, optional PP stages), classifying each the
  way the paper classifies WSE/RDU/IPU scaling (which term saturates first).
* ``measure_*``      — empirical: wall-clock throughput vs batch size /
  precision / mesh split, validating the paper's Tier-2 claims
  (batch-size scaling, precision sensitivity, PP bottleneck =
  most-loaded stage).

The counterpart of ``repro/core/scalability.py``, function for function:
the timer waits for the card (PyTorch returns before the device is done)
where JAX blocked on its arrays, and a point's device count is the
process group's world size (1 without one).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np


@dataclass
class ScalePoint:
    name: str
    devices: int
    throughput: float            # tokens/s (measured) or 1/step_s (analytic)
    step_time_s: float
    extras: dict


def _sync() -> None:
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _devices() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def measure_step(fn: Callable, args: tuple, *, iters: int = 5,
                 warmup: int = 2) -> float:
    """Median wall-clock seconds of a step, the device synchronised after
    each call."""
    # wait after each warmup call (matching bench/runner.timeit_us):
    # waiting only after the last lets queued warmup work leak into the
    # first timed iteration and skews the median low
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def measure_batch_sweep(step_builder: Callable[[int], tuple],
                        batch_sizes: Sequence[int]) -> List[ScalePoint]:
    """Paper Fig. 12: throughput vs batch size. step_builder(b) returns
    (fn, args, tokens_per_step)."""
    out = []
    for b in batch_sizes:
        fn, args, tokens = step_builder(b)
        s = measure_step(fn, args)
        out.append(ScalePoint(name=f"batch{b}", devices=_devices(),
                              throughput=tokens / s, step_time_s=s,
                              extras={"batch": b}))
    return out


def measure_precision_sweep(step_builder: Callable[[str], tuple],
                            dtypes: Sequence[str] = ("float32", "bfloat16"),
                            ) -> List[ScalePoint]:
    """Paper Table IV: throughput per numeric format."""
    out = []
    for dt in dtypes:
        fn, args, tokens = step_builder(dt)
        s = measure_step(fn, args)
        out.append(ScalePoint(name=dt, devices=_devices(),
                              throughput=tokens / s, step_time_s=s,
                              extras={"dtype": dt}))
    return out


def pp_bottleneck_model(stage_layers: Sequence[int],
                        per_layer_time: float, n_microbatches: int) -> float:
    """Paper Fig. 11(c): GPipe step time is governed by the most-loaded
    stage: (M + S - 1) * max_stage_time."""
    S = len(stage_layers)
    tmax = max(stage_layers) * per_layer_time
    return (n_microbatches + S - 1) * tmax


def pp_throughput_ratio(stage_layers: Sequence[int],
                        n_microbatches: int) -> float:
    """Relative throughput of a PP split vs a perfectly balanced one."""
    S = len(stage_layers)
    balanced = sum(stage_layers) / S
    return balanced / max(stage_layers) * (n_microbatches /
                                           (n_microbatches + S - 1))


# --------------------------------------------------------------------------
# Measured mesh-split matrix (Tier-2): metrics for DP/TP/PP sweeps. On
# ranks that share one host's cores (the CPU sweeps) the *ideal*
# strong-scaling outcome is constant wall-clock throughput across splits;
# the deficit from 1.0 is partition + collective overhead, which is
# exactly the signal the paper's Fig. 11 / Table III classification needs
# (which term saturates first).
# --------------------------------------------------------------------------

def scaling_efficiency(throughput_n: float, throughput_1: float) -> float:
    """Measured throughput at an N-way split over the 1-device throughput
    of the SAME global problem. 1.0 = free partitioning; on real hardware
    multiply by N for classic strong-scaling speedup."""
    return throughput_n / throughput_1 if throughput_1 > 0 else 0.0


def collective_time_fraction(step_n_s: float, step_1_s: float) -> float:
    """Upper-bound fraction of an N-way step spent off the critical
    compute path (collectives + partition overhead): on a shared-core
    shared-core mesh total compute is invariant across splits, so any time
    beyond the 1-device step is overhead. Clamped to [0, 1)."""
    if step_n_s <= 0:
        return 0.0
    return max(0.0, 1.0 - step_1_s / step_n_s)


def even_shard_sizes(total: int, shards: int) -> List[int]:
    """Work units per shard when ``total`` items split over ``shards``
    (first ``total % shards`` shards take the extra unit; shards beyond
    ``total`` sit idle with 0)."""
    base, rem = divmod(total, shards)
    return [base + (1 if i < rem else 0) for i in range(shards)]


def shard_balance(work_per_shard: Sequence[float]) -> float:
    """Eq. 3 over per-shard work: resources are one unit per shard,
    throughput_i proportional to assigned work. An idle shard pins the
    index to 0 — the paper's 'one starved task bounds the system'."""
    from repro_torch.core.metrics import load_imbalance

    work = np.asarray(work_per_shard, dtype=np.float64)
    if work.size == 0:
        return 1.0
    return load_imbalance(np.ones_like(work), work)


def pp_stage_balance(stage_layers: Sequence[int]) -> float:
    """Eq. 3 over pipeline stages: stage i's throughput is 1/layers_i, so
    the index reduces to mean(layers)/max(layers) — 1.0 for an even split,
    degrading as one stage hoards layers."""
    from repro_torch.core.metrics import load_imbalance

    layers = np.asarray(stage_layers, dtype=np.float64)
    if layers.size == 0 or layers.min() <= 0:
        return 0.0
    return load_imbalance(np.ones_like(layers), 1.0 / layers)


@dataclass
class PPModelCheck:
    """Measured GPipe step time vs the most-loaded-stage model (Fig. 11c)."""

    measured_s: float
    predicted_s: float
    per_layer_s: float          # calibrated from the balanced split

    @property
    def ratio(self) -> float:
        return self.measured_s / self.predicted_s if self.predicted_s else 0.0

    def within(self, lo: float = 0.45, hi: float = 2.2) -> bool:
        """Tolerance band for shared-core CPU meshes: dispatch overhead and
        host jitter shift absolute times, but a split whose measured step
        escapes this band is not obeying max-stage scaling at all."""
        return lo <= self.ratio <= hi


def pp_model_check(measured_s: float, stage_layers: Sequence[int],
                   n_microbatches: int, per_layer_s: float) -> PPModelCheck:
    """Check one measured PP split against ``pp_bottleneck_model`` using a
    per-layer time calibrated from a balanced reference split."""
    predicted = pp_bottleneck_model(stage_layers, per_layer_s,
                                    n_microbatches)
    return PPModelCheck(measured_s=measured_s, predicted_s=predicted,
                        per_layer_s=per_layer_s)


def pp_calibrate_per_layer(measured_s: float,
                           stage_layers: Sequence[int],
                           n_microbatches: int) -> float:
    """Invert the bottleneck model on a reference split to recover the
    effective per-layer time (schedule overhead included)."""
    S = len(stage_layers)
    denom = (n_microbatches + S - 1) * max(stage_layers)
    return measured_s / denom if denom else 0.0
