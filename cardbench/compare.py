"""The comparisons that decide ``correct``: the program's readings against
the plain reference's, each as one number held to a limit.

Training (per leaf: every weight, a layer stack's weights layer by layer):

* ``loss``: the largest gap of a step's loss, over the first steps, as a
  share of the reference's loss;
* ``grad``: the worst leaf's gap between the norm of its first gradient as
  AdamW gets it (clipped) and the reference's, as a share of the larger of
  the reference's norm of that leaf and of the median leaf;
* ``change``: the same of the norm of each leaf's change over the first
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (Adam moves those by round-off alone).

A cell compares the numbers its limits file names.

Serving, over the sampled requests' served tokens:

* ``logit_err``: the widest gap between the program's logits and the
  reference's at one position, as a share of the reference's largest
  logit there (by magnitude), the worst position;
* ``logit_gap``: the widest gap by which a served token's logit lies below
  the reference's best at its position.
"""
from __future__ import annotations

import statistics

SMALL_GRAD = 1e-3


def _gaps(prog: dict, ref: dict, keep=None) -> list:
    med = statistics.median(ref.values())
    return [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in ref if keep is None or n in keep]


def moved_leaves(ref_grad: dict) -> set:
    med = statistics.median(ref_grad.values())
    return {n for n, v in ref_grad.items() if v >= SMALL_GRAD * med}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [...], "grad": {leaf: norm},
    "change": {leaf: norm}}."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                    ref["losses"]))
    change = _gaps(prog["change"], ref["change"], moved_leaves(ref["grad"]))
    return {"loss": loss, "grad": max(_gaps(prog["grad"], ref["grad"])),
            "change": max(change)}


def logit_gap(ref_logits, tokens) -> float:
    """ref_logits (n, V) at the positions that produced ``tokens`` (n,)."""
    import torch
    tok = torch.as_tensor(tokens, device=ref_logits.device).long()
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tok[:, None])[:, 0]
    return float((best - got).max())


def logit_err(prog, ref) -> float:
    """prog and ref (n, V): the program's and the reference's logits at
    the same n positions."""
    gap = (prog.float() - ref).abs().amax(-1) / ref.abs().amax(-1)
    return float(gap.max())


def worst_leaves(prog: dict, ref: dict, k: int = 3) -> list:
    """The ``k`` leaves of the largest gap, with their gaps (diagnostics)."""
    gaps = dict(zip(ref, _gaps(prog, ref)))
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:k]
