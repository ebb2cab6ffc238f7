"""GPipe-style pipeline parallelism over a mesh axis (the paper's
Graphcore/IPU execution model, §III.C / Fig. 11c): the counterpart of
``repro/parallel/pipeline.py``.

Stages map to slices of the stacked layer parameters (stage s of the
pipe axis holds layers ``sum(stage_layers[:s]) ..``, padded to the
largest stage), microbatches flow from stage to stage by ``send``/
``recv``, and uneven layer-to-stage assignments are first-class: the
Tier-2 benchmark reproduces the paper's finding that throughput is
governed by the most-loaded stage. A correctness- and benchmark-grade
schedule (GPipe, outputs collected on the last stage), as in the
reference.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.parallel.collectives import (axis_index, axis_size, call,
                                              group_of)


def stage_layout(num_layers: int, stage_layers: Sequence[int]):
    """Map layer index -> (stage, slot) with per-stage padding to max."""
    if sum(stage_layers) != num_layers:
        raise ValueError(
            f"stage_layers {tuple(stage_layers)} must sum to "
            f"num_layers={num_layers}")
    lmax = max(stage_layers)
    layer_of = []
    for s, n in enumerate(stage_layers):
        for j in range(n):
            layer_of.append((s, j))
    return lmax, layer_of


def stack_stages(stacked_params, stage_layers: Sequence[int]):
    """(L, ...) param leaves -> ((S, Lmax, ...), valid_mask (S, Lmax))."""
    L = tree_leaves(stacked_params)[0].shape[0]
    S = len(stage_layers)
    lmax, _ = stage_layout(L, stage_layers)
    bounds = np.cumsum([0] + list(stage_layers))
    mask = torch.zeros((S, lmax), dtype=torch.bool)
    for s, n in enumerate(stage_layers):
        mask[s, :n] = True

    def per_leaf(x):
        out = x.new_zeros((S, lmax) + tuple(x.shape[1:]))
        for s in range(S):
            out[s, : stage_layers[s]] = x[bounds[s]:bounds[s + 1]]
        return out

    return tree_map(per_leaf, stacked_params), mask


def pipeline_forward(stage_params, stage_mask, mbs, layer_fn, mesh,
                     *, axis: str = "model"):
    """GPipe forward over ``M + S - 1`` ticks. This rank is stage ``s``
    (its index over ``axis``); ``stage_params`` leaves (Lmax, ...) are its
    slice of :func:`stack_stages`'s output and ``stage_mask`` (Lmax,) its
    valid slots. mbs: (M, mb, S_seq, d) microbatch activations, the same
    on every stage. At tick t stage s runs microbatch t - s: stage 0 takes
    it from ``mbs``, the others receive it from the stage before, and each
    but the last sends its output on. Returns (M, mb, S_seq, d), the last
    stage's outputs, broadcast to every stage.

    layer_fn(x, p_layer) -> x."""
    M = mbs.shape[0]
    s, S = axis_index(mesh, axis), axis_size(mesh, axis)
    group = group_of(mesh, axis)
    ranks = dist.get_process_group_ranks(group)
    valid = [bool(v) for v in stage_mask]
    layers = [tree_map(lambda a, j=j: a[j], stage_params)
              for j in range(len(valid))]

    def run_stage(x):
        for p, ok in zip(layers, valid):
            if ok:
                x = layer_fn(x, p)
        return x

    outs = torch.zeros_like(mbs)
    for t in range(M + S - 1):
        mb = t - s
        if not 0 <= mb < M:
            continue
        if s == 0:
            x = mbs[mb]
        else:
            x = torch.empty_like(mbs[0])
            call(dist.recv, x, src=ranks[s - 1], group=group)
        y = run_stage(x)
        if s < S - 1:
            call(dist.send, y.contiguous(), dst=ranks[s + 1], group=group)
        else:
            outs[mb] = y
    call(dist.broadcast, outs, src=ranks[S - 1], group=group)
    return outs


def pipeline_step_time(stage_layers: Sequence[int], per_layer_s: float,
                       n_microbatches: int) -> float:
    """Analytic GPipe step time: (M + S - 1) x slowest stage."""
    return (n_microbatches + len(stage_layers) - 1) * \
        max(stage_layers) * per_layer_s


def stage_utilization(stage_layers: Sequence[int]) -> List[float]:
    """Useful-layer fraction per stage under the padded schedule: every
    stage takes Lmax layer slots' time, so stage s does n_s/Lmax useful
    work -- the per-stage Eq. 1 allocation ratio of the pipeline."""
    if not stage_layers:
        return []
    lmax = max(stage_layers)
    return [n / lmax for n in stage_layers]


def pipeline_allocation(stage_layers: Sequence[int]) -> float:
    """Eq. 2 over pipeline stages: mean(n_s) / Lmax. 1.0 = perfectly even
    split."""
    util = stage_utilization(stage_layers)
    return sum(util) / len(util) if util else 0.0
