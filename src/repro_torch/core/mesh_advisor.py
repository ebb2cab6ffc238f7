"""Mesh advisor — Tier-2 deployment guidance, analytically.

The (data, model) split is the highest-leverage deployment knob. This
module ranks the splits before anything runs: for each candidate it
estimates the three
roofline terms from the structural op graph + first-principles collective
models, checks the HBM budget, and ranks candidates by roofline step time.

Collective model per candidate (per device, per step):
* TP activation all-reduce: 2 x n_psum_sites x tokens_local x d x bytes
  x (m-1)/m       (fwd psum + bwd dgrad psum of column-parallel matmuls)
* ZeRO-3 weight all-gather: microbatches x fwd_bwd x param_bytes/model
  x (dp-1)/dp     (per-mb re-gather, sharded residue over model)
* gradient reduce-scatter: param_bytes/model x (dp-1)/dp

HBM model: params + opt state + gradient accumulator (all /devices) +
gathered-weight working set (params/(L x model) x 2 buffers) + remat stack
(L x tokens_local x d x 2B / layers_per_block).

The counterpart of ``repro/core/mesh_advisor.py``: every rate and the
device memory come from a :class:`~repro_torch.core.roofline.Chip`
(``chip``, by default the H100: bf16 peak, HBM rate, one link's rate one
way, device memory).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Mapping, Optional

from repro_torch.configs.base import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.core.roofline import H100, Chip


@dataclass
class MeshAdvice:
    mesh: MeshConfig
    microbatches: int
    compute_s: float
    memory_s: float
    collective_s: float
    hbm_gb: float
    fits: bool

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self) -> str:
        return max(("compute", "memory", "collective"),
                   key=lambda k: getattr(self, k + "_s"))


def _opt_bytes_per_param(params: float) -> float:
    # mirrors the reference's launch/cells.py policy: int8 state + no
    # master for >200B
    return 2 + (2.5 if params > 2e11 else 12 + 4)  # bf16 p + states (+grad)


def advise(cfg: ModelConfig, shape: ShapeConfig, n_devices: int = 256,
           *, candidates: Optional[List[int]] = None,
           seqs_per_device: int = 1,
           calibration: Optional[Mapping[str, float]] = None,
           chip: Chip = H100) -> List[MeshAdvice]:
    """Rank (data, model) splits of `n_devices` for a training shape.

    `calibration` switches the advisor from analytic peaks to rates a
    captured trace actually measured (a plain mapping):
    `flops_per_s` / `hbm_bytes_per_s` / `ici_bytes_per_s` replace
    ``chip``'s peaks, and
    `useful_flops_scale` inflates the analytic FLOP count by the
    measured HLO-vs-analytic ratio (remat and attention overhead the
    closed-form 6*P*tokens estimate misses). Missing keys keep their
    analytic defaults, so partial calibrations compose.
    """
    cal = dict(calibration or {})
    flops_rate = float(cal.get("flops_per_s", chip.peak("bfloat16")))
    hbm_rate = float(cal.get("hbm_bytes_per_s", chip.hbm_bw))
    ici_rate = float(cal.get("ici_bytes_per_s", chip.link_bw))
    flops_scale = float(cal.get("useful_flops_scale", 1.0))
    P = float(cfg.param_count())
    P_act = float(cfg.active_param_count())
    tokens = shape.global_batch * shape.seq_len
    d = cfg.d_model
    L = cfg.num_layers + cfg.encoder_layers
    out: List[MeshAdvice] = []
    candidates = candidates or [1, 2, 4, 8, 16, 32, 64]
    for model in candidates:
        if n_devices % model:
            continue
        dp = n_devices // model
        if shape.global_batch % dp and dp > shape.global_batch:
            continue
        # weights must divide: approximate with d_ff/heads granularity
        if model > 1 and cfg.d_ff % model:
            continue
        mb_size = min(shape.global_batch, seqs_per_device * dp)
        n_mb = max(1, shape.global_batch // mb_size)
        tokens_local = tokens / dp
        fwd_bwd = 3.0 if shape.kind == "train" else 1.0

        compute = (fwd_bwd * 2.0 * P_act * tokens * flops_scale
                   / n_devices / flops_rate)
        # memory: weights read per mb + activations ~10 passes
        w_reads = n_mb * fwd_bwd * (P_act / model) * 2
        act_reads = fwd_bwd * 10 * tokens_local * d * 2
        memory = (w_reads + act_reads) / hbm_rate

        tp_sites = 4 if cfg.moe is None else 2   # psums/layer (fwd+bwd)
        coll = 0.0
        if model > 1:  # Megatron activation psums: per layer, per site
            coll += (tp_sites * L * tokens_local * d * 2
                     * 2 * (model - 1) / model)
        if dp > 1:  # ZeRO-3 per-microbatch weight gathers (fwd + bwd
            # recompute) + one grad reduce-scatter per step
            coll += n_mb * 2.5 * (P / model) * 2 * (dp - 1) / dp
            coll += (P / model) * 4 * (dp - 1) / dp
        collective = coll / ici_rate

        hbm = (P * _opt_bytes_per_param(P) / n_devices
               + (P / (L * model)) * 2 * 2          # gathered layer weights
               + L * (tokens_local / max(n_mb, 1)) * d * 2)
        out.append(MeshAdvice(
            mesh=MeshConfig(shape=(dp, model), axes=("data", "model")),
            microbatches=n_mb,
            compute_s=compute, memory_s=memory, collective_s=collective,
            hbm_gb=hbm / 1e9, fits=hbm <= chip.hbm_bytes))
    out.sort(key=lambda a: (not a.fits, a.step_s))
    return out


def best_mesh(cfg: ModelConfig, shape: ShapeConfig,
              n_devices: int = 256, *, chip: Chip = H100) -> MeshAdvice:
    ranked = advise(cfg, shape, n_devices, chip=chip)
    fitting = [a for a in ranked if a.fits]
    return (fitting or ranked)[0]
