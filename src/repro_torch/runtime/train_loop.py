"""Fault-tolerant training loop: the PyTorch counterpart of
``repro/runtime/train_loop.py``.

* auto-resume from the newest committed checkpoint, restored IN PLACE
  into the given params and optimizer state
  (:mod:`repro_torch.checkpoint.checkpoint`);
* periodic async checkpointing every ``ckpt_every`` committed steps (the
  host copies are taken before the step after it updates the state in
  place; the files are written on a thread), and a final save;
* bounded step retry on transient failures: a step that raised before it
  began its update is run again on the same (untouched) params and
  optimizer state. The port's step updates both IN PLACE, so a step that
  failed inside its update raises :class:`UpdateFailed`, which the loop
  re-raises instead of retrying on a half-updated state;
* straggler watchdog: per-step wall-time EWMA + sigma; steps slower than
  mean + k*sigma are logged and counted;
* loss-spike guard: a step whose loss is not finite skips its update (the
  port's step checks before updating) and the loop records no loss.
"""
from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt

log = logging.getLogger("repro_torch.train")


class UpdateFailed(RuntimeError):
    """A step failed after it began updating params or optimizer state in
    place; the state is no longer the step's input, so it is not retried."""


@dataclass
class StragglerWatchdog:
    """EWMA step-time monitor; flags steps slower than mean + k*sigma."""
    k: float = 3.0
    alpha: float = 0.1
    mean: float = 0.0
    var: float = 0.0
    steps: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.steps += 1
        if self.steps == 1:
            self.mean = dt
            return False
        sigma = math.sqrt(max(self.var, 1e-12))
        is_straggler = self.steps > 5 and dt > self.mean + self.k * sigma
        if is_straggler:
            self.flagged.append((step, dt))
            log.warning("straggler step %d: %.3fs (mean %.3fs + %g sigma)",
                        step, dt, self.mean, self.k)
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler


@dataclass
class TrainLoopResult:
    final_step: int
    losses: list
    resumed_from: Optional[int]
    retries: int
    stragglers: int
    checkpoints: list
    metrics: list = field(default_factory=list)   # per committed step


def run(train_step: Callable, params, opt_state, data_iter_fn: Callable,
        *, total_steps: int, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 50, max_retries: int = 3,
        watchdog: Optional[StragglerWatchdog] = None,
        fail_injector: Optional[Callable[[int], None]] = None,
        sharding: Optional[tuple] = None) -> TrainLoopResult:
    """data_iter_fn(step) -> batch (deterministic => retry-safe).
    fail_injector(step) may raise to simulate node failures (tests).
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with a ``"loss"`` metric. Each committed step's metrics,
    as Python floats (a tensor metric as its ``tolist()``: the moe
    family's ``expert_load`` is (L, E)), with its wall time ``step_s``
    (the loss read synchronises with the device), land in ``metrics``.
    With ``ckpt_dir`` the loop starts after the newest committed step
    there (``resumed_from``), restored into ``params`` and ``opt_state``,
    saves every ``ckpt_every`` committed steps and after the last step,
    and lists the saved steps in ``checkpoints``. ``sharding``: (the spec
    tree of ``{"params", "opt"}``, the ``DeviceMesh``) of a sharded run,
    whose checkpoints hold the full leaves and restore into this rank's
    shards (every rank calls; the saves block)."""
    specs, mesh = sharding if sharding is not None else (None, None)
    watchdog = watchdog or StragglerWatchdog()
    resumed_from = None
    start = 0
    if ckpt_dir:
        step0, _ = ckpt.restore_latest(ckpt_dir,
                                       {"params": params, "opt": opt_state},
                                       specs=specs, mesh=mesh)
        if step0 is not None:
            start = step0 + 1
            resumed_from = step0
            log.info("resumed from checkpoint step %d", step0)
    losses: list = []
    metrics_log: list = []
    saves: list = []
    pending_save = None
    retries = 0
    step = start
    try:
        while step < total_steps:
            batch = data_iter_fn(step)
            t0 = time.perf_counter()
            try:
                if fail_injector is not None:
                    fail_injector(step)
                new_params, new_opt, metrics = train_step(params, opt_state,
                                                          batch)
                loss = float(metrics["loss"])
            except UpdateFailed:
                raise
            except Exception as e:             # transient failure -> retry
                retries += 1
                log.warning("step %d failed (%s); retry %d/%d", step, e,
                            retries, max_retries)
                if retries > max_retries:
                    raise
                continue
            if not math.isfinite(loss):        # loss spike -> update skipped
                log.warning("non-finite loss at step %d; update skipped", step)
                step += 1
                continue
            dt = time.perf_counter() - t0
            params, opt_state = new_params, new_opt
            losses.append(loss)
            metrics_log.append({**{k: v.tolist() if torch.is_tensor(v)
                                    else float(v)
                                    for k, v in metrics.items()},
                                "step_s": dt})
            watchdog.observe(step, dt)
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                if pending_save is not None:
                    pending_save.join()
                pending_save = ckpt.save(ckpt_dir, step,
                                         {"params": params, "opt": opt_state},
                                         blocking=mesh is not None,
                                         specs=specs, mesh=mesh)
                saves.append(step)
            step += 1
    finally:     # a save in flight is finished, also when a step raises
        if pending_save is not None:
            pending_save.join()
    if ckpt_dir and (not saves or saves[-1] != step - 1) and step > start:
        ckpt.save(ckpt_dir, step - 1, {"params": params, "opt": opt_state},
                  specs=specs, mesh=mesh)
        saves.append(step - 1)
    return TrainLoopResult(final_step=step, losses=losses,
                           resumed_from=resumed_from, retries=retries,
                           stragglers=len(watchdog.flagged),
                           checkpoints=saves, metrics=metrics_log)
