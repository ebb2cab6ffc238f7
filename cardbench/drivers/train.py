"""The driver of a training mix (``"kind": "train"``).

Set-up builds the program's training step over the benchmark's weights
and drives it from the seed through the mix's first ``check_steps`` steps,
through the same call and feed as the window, reading what the check
compares: each step's loss, each leaf's first gradient as AdamW got it
(its first moment after one step over 1 - beta1) and each leaf's change
over those steps. The window then runs whole steps for ``--seconds``:
``train_tok_s`` is the tokens of every step it ran over the time from the
first step's start to the synchronised end of the last, ``train_peak_gib``
the device's allocation peak over them. A traced run profiles
``traced_steps`` more steps after the window. Last, with the program's
state freed, the plain reference follows the first steps from the same
weights and batches.
"""
from __future__ import annotations

import gc
import time

import torch

from cardbench import compare, program, weights, workcount
from cardbench import traffic as tr
from cardbench.harness import Outcome
from cardbench.reference import common
from cardbench.trace import Tracer, span


def batch(seed: int, step: int, c: dict, t: dict, device):
    """(tokens, labels), (rows, seq) each, of step ``step``."""
    rows = tr.packed_rows(seed, step, t["rows"], t["seq"], c["vocab_size"],
                          t["doc"]["mean_len"], t["doc"]["zipf_a"])
    x = torch.from_numpy(rows).to(device)
    return x[:, :-1], x[:, 1:]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def change_norms(params: dict, c: dict, seed: int, device) -> dict:
    """Each leaf's norm of its change since the seed's weights."""
    p0 = weights.make(c, seed, device)
    named0 = dict(weights.per_layer(p0))
    named = weights.per_layer(params)
    vals = torch.stack([(t.detach() - named0[n]).float().norm()
                        for n, t in named]).tolist()
    del p0, named0
    return {n: v for (n, _), v in zip(named, vals)}


def reference_readings(c: dict, t: dict, seed: int, device, *,
                       precision: str = "float32", rows_kept: int = 0):
    """The plain reference's readings over the first ``check_steps`` steps:
    losses, first clipped gradient norms and change norms by leaf. The
    control computes in ``precision="tf32"``; ``rows_kept`` leaves the
    other rows of each batch out (a planted fault)."""
    common.fp32_only()
    mm = common.matmul_of(precision)
    init = weights.make(c, seed, device)
    paths = [p for p, _ in weights.leaves(init)]
    leaves = [x.detach().requires_grad_() for _, x in weights.leaves(init)]
    del init
    tree = weights.tree_of(paths, leaves)
    state, losses, grad = {}, [], None
    for s in range(t["check_steps"]):
        tok, lab = batch(seed, s, c, t, device)
        if rows_kept:
            tok, lab = tok[:rows_kept], lab[:rows_kept]
        n_mb = min(t["microbatches"], tok.shape[0])
        mb = tok.shape[0] // n_mb
        acc = [torch.zeros_like(x) for x in leaves]
        total = 0.0
        for i in range(n_mb):
            lo = common.loss(tree, tok[i * mb:(i + 1) * mb],
                             lab[i * mb:(i + 1) * mb], c, mm,
                             remat=t["remat"])
            for a, g in zip(acc, torch.autograd.grad(lo, leaves)):
                a.add_(g)
            total += float(lo.detach())
        acc = [a.div_(n_mb) for a in acc]
        losses.append(total / n_mb)
        clip = common.adamw(leaves, acc, state, t["optimizer"])
        if s == 0:
            grad = weights.norms(weights.tree_of(paths, acc), clip)
        del acc
    change = change_norms(tree, c, seed, device)
    return {"losses": losses, "grad": grad, "change": change}


def program_setup(c: dict, t: dict, seed: int, device, marks=None):
    """The program's trainer after the first ``check_steps`` steps, and its
    readings over them; ``marks`` gets the time each part ended."""
    marks = {} if marks is None else marks
    prog = program.Trainer(c, t, weights.make(c, seed, device), device)
    _sync(device)
    marks["weights and step built"] = time.perf_counter()
    losses, grad = [], None
    for s in range(t["check_steps"]):
        losses.append(prog.step(*batch(seed, s, c, t, device)))
        if s == 0:
            grad = weights.norms(prog.first_moments(), 1 / (1 - prog.b1))
    change = change_norms(prog.params, c, seed, device)
    marks[f"{t['check_steps']} checked steps"] = time.perf_counter()
    return prog, {"losses": losses, "grad": grad, "change": change}


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> Outcome:
    c, t = cell.config, cell.traffic
    marks = {"imports": time.perf_counter()}
    prog, readings = program_setup(c, t, seed, device, marks)
    tracer = Tracer(device) if trace else None
    if tracer:
        tracer.warm()
    step = t["check_steps"]
    _sync(device)
    setup_s = time.perf_counter() - t_process
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        prog.step(*batch(seed, step + n, c, t, device))
        n += 1
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    tokens = t["rows"] * t["seq"]
    counts = {"steps": n, "window_s": window_s, "dtype": c["dtype"],
              "step_flops": workcount.train_step_flops(c, t["rows"],
                                                       t["seq"])}
    traced = None
    if tracer:
        tracer.start()
        for k in range(t["traced_steps"]):
            with span("train.step"):
                prog.step(*batch(seed, step + n + k, c, t, device))
        traced = tracer.stop(steps=t["traced_steps"])
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(c, t, seed, device)
    nums = compare.train_numbers(readings, ref)
    return Outcome(
        end_to_end={"train_tok_s": n * tokens / window_s,
                    "train_peak_gib": peak / 2 ** 30, "setup_s": setup_s},
        counts=counts, trace=traced,
        checks=[(k, nums[k], lim) for k, lim in cell.limits.items()],
        attempted=n, failed=0, memory_peak_bytes=peak,
        notes=[setup_note(t_process, marks)])


def setup_note(t_process: float, marks: dict) -> str:
    """Where the set-up's seconds went, part by part."""
    parts, prev = [], t_process
    for name, t in marks.items():
        parts.append(f"{name} {t - prev:.3f}")
        prev = t
    return "setup s: " + ", ".join(parts)
