"""Three-term roofline model of the card the port runs on.

    compute    = counted FLOPs      / (peak FLOP/s of the run's dtype)
    memory     = counted bytes      / (HBM bytes/s)
    collective = link bytes (ring)  / (interconnect bytes/s)

The counts come from one real call of the program on one device
(:func:`repro_torch.core.cost.count_cost`), so they are per-device
already. Every function that reads a peak takes a :class:`Chip`, by
default :data:`H100`; nothing else in the port holds a hardware constant.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, Mapping, Optional, Tuple

if TYPE_CHECKING:
    from repro_torch.core.cost import CostReport


@dataclass(frozen=True)
class Chip:
    """One device's peaks. ``peak_flops`` and ``mma_tiles`` are keyed by
    dtype name (``float32``, ``tf32``, ``bfloat16``)."""
    name: str
    peak_flops: Mapping[str, float]
    hbm_bw: float                 # bytes/s
    hbm_bytes: float
    link_bw: float                # bytes/s one way, for the collective term
    mma_tiles: Mapping[str, Tuple[int, ...]] = field(default_factory=dict)

    def peak(self, dtype: str) -> float:
        if dtype not in self.peak_flops:
            raise KeyError(f"{self.name} has no peak for {dtype!r}; it has "
                           f"{sorted(self.peak_flops)}")
        return self.peak_flops[dtype]

    def mma_tile(self, dtype: str) -> Tuple[int, ...]:
        if dtype not in self.mma_tiles:
            raise KeyError(f"{self.name} has no matrix tile for {dtype!r}")
        return self.mma_tiles[dtype]


# NVIDIA H100 SXM5 80 GB, dense rates without sparsity (NVIDIA H100 Tensor
# Core GPU datasheet): 67 TFLOP/s f32 on the FMA units (the port keeps TF32
# off, as its tolerances need), 495 TFLOP/s TF32 and 989 TFLOP/s bf16 on
# the tensor cores, 3.35 TB/s HBM3, 80 GB. NVLink 4: 900 GB/s a GPU (the
# same datasheet), counted over both directions; the collective term
# takes one direction, 450 GB/s. Rates assume the full 700 W power limit.
H100 = Chip(
    name="NVIDIA H100 SXM5 80GB",
    peak_flops={"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12},
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    link_bw=450e9,
    # mma.sync shapes (m, n, k): m16n8k8 for TF32, which the port's f32
    # kernels run as 3xTF32, and m16n8k16 for bf16
    mma_tiles={"float32": (16, 8, 8), "tf32": (16, 8, 8),
               "bfloat16": (16, 8, 16)},
)


@dataclass
class RooflineReport:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float      # raw operand-bytes sum
    collective_ici_bytes_per_device: float  # ring-model per-device link traffic
    model_flops: float = 0.0                # 6*N*D analytic (global)
    chips: int = 1
    collective_breakdown: Dict[str, float] = field(default_factory=dict)
    dtype: str = "float32"                  # the run's dtype: whose peak
    peak_flops: float = 0.0                 # that peak, FLOP/s a device
    chip: str = ""

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time: max of the three terms (perfect
        overlap assumption)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / counted FLOPs (global): catches remat and
        redundant work."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else None

    @property
    def mfu(self) -> Optional[float]:
        """Model-flops utilization at the roofline-optimistic step time,
        against the run dtype's peak."""
        if not self.model_flops or not self.step_time_s:
            return None
        return self.model_flops / (self.chips * self.peak_flops
                                   * self.step_time_s)

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_ici_bytes_per_device":
                self.collective_ici_bytes_per_device,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
            "step_time_s": self.step_time_s,
            "collective_breakdown": self.collective_breakdown,
            "chip": self.chip,
            "dtype": self.dtype,
            "peak_flops": self.peak_flops,
        }


def roofline(report: "CostReport", *, chips: int, model_flops: float = 0.0,
             dtype: str = "float32", chip: Chip = H100) -> RooflineReport:
    """The three terms of a per-device cost report on ``chip``, the compute
    term against the peak of the run's ``dtype``."""
    ici = report.collective_ici_bytes
    peak = chip.peak(dtype)
    return RooflineReport(
        compute_s=report.flops / peak,
        memory_s=report.bytes / chip.hbm_bw,
        collective_s=ici / chip.link_bw,
        flops_per_device=report.flops,
        bytes_per_device=report.bytes,
        collective_bytes_per_device=report.collective_bytes,
        collective_ici_bytes_per_device=ici,
        model_flops=model_flops,
        chips=chips,
        collective_breakdown=report.collective_summary(),
        dtype=dtype, peak_flops=peak, chip=chip.name,
    )


def model_flops_train(n_active_params: float, tokens: float) -> float:
    return 6.0 * n_active_params * tokens


def model_flops_decode(n_active_params: float, batch: float) -> float:
    return 2.0 * n_active_params * batch


def model_flops_prefill(n_active_params: float, tokens: float) -> float:
    return 2.0 * n_active_params * tokens
