"""Tier-1 orchestrator: one call -> the paper's intra-chip profile of a
(model x shape x mesh) cell on the card, the port's counterpart of
``repro/core/profiler.py``, combining

* structural metrics (always available): O0/O1/O3 section allocation and
  load imbalance (Eq. 2-4) and arithmetic intensity (Eq. 5);
* counted metrics, when a :class:`~repro_torch.core.cost.CostReport` of
  one real step is given (it stands where the JAX package reads compiled
  HLO): the roofline terms and the matrix units' busy share;
* measured metrics, when ``measured`` is given: the step's seconds, and
  from :func:`repro_torch.core.profile.profile_device` the device's busy
  share and device time by kernel group; ``mfu_measured`` = model flops /
  (peak x measured step).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.bench.record import BenchRecord
from repro_torch.configs.base import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.core import metrics, sections
from repro_torch.core.cost import CostReport
from repro_torch.core.roofline import (H100, Chip, model_flops_decode,
                                       model_flops_prefill, model_flops_train,
                                       roofline)

MODES = ("O0", "O1", "O3")
# the profile_device fields a Tier-1 report keeps beside the step time
MEASURED_KEYS = ("device_busy_share", "device_span_ms", "kernel_launches",
                 "device_ms_by_group")


@dataclass
class Tier1Report:
    arch: str
    shape: str
    mesh: str
    sections: Dict[str, dict]            # O0/O1/O3 -> SectionReport dict
    arithmetic_intensity: float          # Eq. 5
    roofline: Optional[dict] = None      # from a counted step, when given
    mma_busy_fraction: Optional[float] = None
    extras: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "sections": self.sections,
            "arithmetic_intensity": self.arithmetic_intensity,
            "roofline": self.roofline,
            "mma_busy_fraction": self.mma_busy_fraction,
            **self.extras,
        }

    def to_records(self) -> List[BenchRecord]:
        """The profile as BenchRecord rows, the interchange the benchmark
        harness emits."""
        cell = f"{self.arch}/{self.shape}"
        recs = []
        for mode, sec in self.sections.items():
            recs.append(BenchRecord(
                name=f"tier1/{cell}/{mode}", scenario="tier1/sections",
                group="tier1", arch=self.arch, shape=self.shape,
                mesh=self.mesh, knobs={"mode": mode},
                paper_ref="Table I / Fig. 6-8",
                derived={"allocation": sec["allocation"],
                         "LI": sec["load_imbalance"],
                         "n_sections": sec["n_sections"],
                         "runtime_s": sec["total_runtime"]}))
        derived: Dict[str, object] = {"AI": self.arithmetic_intensity}
        if self.roofline:
            derived.update(
                dom=self.roofline.get("dominant"),
                compute_s=self.roofline.get("compute_s"),
                memory_s=self.roofline.get("memory_s"),
                collective_s=self.roofline.get("collective_s"),
                mfu=self.roofline.get("mfu"))
        if self.mma_busy_fraction is not None:
            derived["mma_busy"] = self.mma_busy_fraction
        measured = self.extras.get("measured", {})
        for key in ("step_s", "mfu_measured"):
            if key in measured:
                derived[key] = measured[key]
        recs.append(BenchRecord(
            name=f"tier1/{cell}/roofline", scenario="tier1/roofline",
            group="tier1", arch=self.arch, shape=self.shape, mesh=self.mesh,
            paper_ref="Fig. 10", derived=derived))
        return recs


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_act = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return model_flops_train(n_act, tokens)
    if shape.kind == "prefill":
        return model_flops_prefill(n_act, tokens)
    return model_flops_decode(n_act, shape.global_batch)


def profile(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshConfig,
            cost: Optional[CostReport] = None,
            measured: Optional[dict] = None, chip: Chip = H100,
            dtype: str = "bfloat16") -> Tier1Report:
    """The Tier-1 report of a cell on ``chip``, with the run's ``dtype``
    (its element width in the section graph, its peak in every compute
    term). ``cost``: a counted step (per device); ``measured``: at least
    ``step_s`` (seconds of that step on the card), optionally the fields
    of :func:`repro_torch.core.profile.profile_device`."""
    sec = {m: sections.analyze(cfg, shape, mesh, m, chip, dtype).to_dict()
           for m in MODES}
    act_bytes = metrics.activation_bytes_estimate(
        cfg.num_layers + cfg.encoder_layers, shape.global_batch,
        shape.seq_len, cfg.d_model)
    ai = metrics.arithmetic_intensity(
        cfg.active_param_count(), shape.global_batch, shape.seq_len,
        act_bytes)
    model_flops = model_flops_for(cfg, shape)
    rl = mma_busy = None
    if cost is not None:
        rlr = roofline(cost, chips=mesh.num_devices, model_flops=model_flops,
                       dtype=dtype, chip=chip)
        rl = rlr.to_dict()
        # matrix units' busy share: product time at peak over the roofline
        # step time, the stand-in for the paper's compute-PE allocation
        mma_busy = (cost.dot_flops / chip.peak(dtype)
                    / max(rlr.step_time_s, 1e-12))
    # Eq. 5's intensity against the chip's ridge: above it, compute-bound
    extras = {"ridge_intensity": metrics.ridge_intensity(dtype, chip)}
    if measured is not None:
        step_s = float(measured["step_s"])
        extras["measured"] = {
            "step_s": step_s,
            "mfu_measured": model_flops / (mesh.num_devices
                                           * chip.peak(dtype) * step_s),
            **{k: measured[k] for k in MEASURED_KEYS if k in measured}}
    return Tier1Report(
        arch=cfg.name, shape=shape.name,
        mesh="x".join(map(str, mesh.shape)), sections=sec,
        arithmetic_intensity=ai, roofline=rl, mma_busy_fraction=mma_busy,
        extras=extras)
