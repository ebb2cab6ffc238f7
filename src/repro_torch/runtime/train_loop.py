"""Training loop with step retry and a straggler watchdog: the PyTorch
counterpart of ``repro/runtime/train_loop.py``.

* bounded step retry on transient failures: a step that raised before it
  began its update is run again on the same (untouched) params and
  optimizer state. The port's step updates both IN PLACE, so a step that
  failed inside its update raises :class:`UpdateFailed`, which the loop
  re-raises instead of retrying on a half-updated state;
* straggler watchdog: per-step wall-time EWMA + sigma; steps slower than
  mean + k*sigma are logged and counted;
* loss-spike guard: a step whose loss is not finite skips its update (the
  port's step checks before updating) and the loop records no loss.

Checkpointing comes with the checkpoint slice (ROADMAP.md A.5).
"""
from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

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
        fail_injector: Optional[Callable[[int], None]] = None
        ) -> TrainLoopResult:
    """data_iter_fn(step) -> batch (deterministic => retry-safe).
    fail_injector(step) may raise to simulate node failures (tests).
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with a ``"loss"`` metric. Each committed step's metrics,
    as Python floats (a tensor metric as its ``tolist()``: the moe
    family's ``expert_load`` is (L, E)), with its wall time ``step_s``
    (the loss read synchronises with the device), land in ``metrics``."""
    if ckpt_dir:
        raise NotImplementedError(
            "ckpt_dir: checkpointing and resume come with the checkpoint "
            "slice of the port (ROADMAP.md A.5)")
    watchdog = watchdog or StragglerWatchdog()
    losses: list = []
    metrics_log: list = []
    retries = 0
    step = 0
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
        step += 1
    return TrainLoopResult(final_step=step, losses=losses,
                           resumed_from=None, retries=retries,
                           stragglers=len(watchdog.flagged),
                           checkpoints=[], metrics=metrics_log)
