"""Section partitioner: the paper's SambaNova O0/O1/O3 compile-mode analysis
(Fig. 4/7/8), applied to a structural op graph built from the
ModelConfig. Copied from ``repro/core/sections.py``, with the chip's
peaks passed in (:class:`~repro_torch.core.roofline.Chip`) and the
element width of the run's dtype.

For each op we know its FLOPs, bytes and which mesh axes participate
(from the sharding rules of the reference's program), so every paper
metric evaluates analytically:

* O0  — one section per operator
* O1  — operator-fusion modules (attention block / mlp block / moe block)
* O3  — one section per decoder layer

Section runtime model: max(flops / (participation * peak),
bytes / (participation * hbm_bw)) — the roofline-optimistic estimate on the
devices the section actually occupies.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from repro_torch.configs.base import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.core import metrics
from repro_torch.core.roofline import H100, Chip

DTYPE_BYTES = {"float32": 4.0, "tf32": 4.0, "bfloat16": 2.0}


@dataclass
class OpNode:
    name: str
    module: str              # fusion group for O1 (attn | ffn | embed | head)
    layer: int               # -1 for non-layer ops
    flops: float             # global
    bytes: float             # global
    participation: float     # fraction of mesh devices doing useful work
    unit: str = "mma"        # mma (matrix units) | alu (elementwise)


@dataclass
class Section:
    name: str
    ops: List[OpNode] = field(default_factory=list)

    @property
    def flops(self) -> float:
        return sum(o.flops for o in self.ops)

    @property
    def bytes(self) -> float:
        return sum(o.bytes for o in self.ops)

    @property
    def participation(self) -> float:
        if not self.ops:
            return 0.0
        t = sum(o.flops + o.bytes for o in self.ops)
        if not t:
            return max(o.participation for o in self.ops)
        return sum(o.participation * (o.flops + o.bytes) for o in self.ops) / t

    def runtime(self, n_devices: int, chip: Chip = H100,
                dtype: str = "bfloat16") -> float:
        p = max(self.participation, 1e-9) * n_devices
        return max(self.flops / (p * chip.peak(dtype)),
                   self.bytes / (p * chip.hbm_bw), 1e-12)

    def throughput(self, n_devices: int, chip: Chip = H100,
                   dtype: str = "bfloat16") -> float:
        return 1.0 / self.runtime(n_devices, chip, dtype)


# ------------------------------------------------------------- op graph
def build_op_graph(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshConfig,
                   dtype: str = "bfloat16") -> List[OpNode]:
    """Structural op graph for one training/prefill step (per step, global
    flops/bytes), activations and weights ``dtype`` wide, norms in f32.
    Participation comes from the sharding rules: ops whose weights
    replicate over `model` (rwkv/ssd projections, non-divisible vocab)
    occupy only the data axes."""
    B, S = shape.global_batch, shape.seq_len
    T = B * S
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    hd, nq, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    bf = DTYPE_BYTES[dtype]
    fwd_bwd = 3.0 if shape.kind == "train" else 1.0
    data_frac = (min(B, mesh.data_size) / mesh.data_size
                 if mesh.data_size else 1.0)
    full = data_frac                      # sharded over data + model axes
    model_idle = data_frac / mesh.model_size  # replicated over model

    ops: List[OpNode] = []

    def add(name, module, layer, fl, by, part, unit="mma"):
        ops.append(OpNode(name, module, layer, fl * fwd_bwd, by * fwd_bwd,
                          min(part, 1.0), unit))

    add("embed", "embed", -1, 2 * T * d, T * d * bf + cfg.vocab_size * d * bf,
        full)
    for l in range(L):
        if cfg.family == "ssm":
            hs = cfg.ssm.head_size
            add(f"l{l}.norm1", "attn", l, 5 * T * d, 2 * T * d * 4,
                model_idle, "alu")
            add(f"l{l}.rkvgw_proj", "attn", l, 2 * T * d * d * 5,
                5 * (T * d * bf + d * d * bf), model_idle)
            add(f"l{l}.wkv", "attn", l, 4 * T * d * hs + 2 * T * d * hs,
                4 * T * d * bf, model_idle)
            add(f"l{l}.time_out", "attn", l, 2 * T * d * d,
                T * d * bf + d * d * bf, model_idle)
            add(f"l{l}.norm2", "ffn", l, 5 * T * d, 2 * T * d * 4,
                model_idle, "alu")
            add(f"l{l}.channel_mix", "ffn", l, 2 * T * d * f * 2 + 2 * T * d * d,
                T * (d + f) * bf + (2 * d * f + d * d) * bf, full)
            continue
        # attention family
        add(f"l{l}.norm1", "attn", l, 5 * T * d, 2 * T * d * 4, full, "alu")
        qkv_f = 2 * T * d * (nq + 2 * nkv) * hd
        add(f"l{l}.qkv_proj", "attn", l, qkv_f,
            T * d * bf + d * (nq + 2 * nkv) * hd * bf, full)
        span = min(S, cfg.window) if cfg.attention_kind == "sliding" else S
        attn_f = 2 * 2 * B * S * span * nq * hd * (0.5 if span == S else 1.0)
        add(f"l{l}.attention", "attn", l, attn_f,
            2 * T * nq * hd * bf + 2 * B * span * nkv * hd * bf, full)
        add(f"l{l}.o_proj", "attn", l, 2 * T * nq * hd * d,
            T * d * bf * 2, full)
        if cfg.family == "hybrid":
            N = cfg.ssm.state_size
            H = d // cfg.ssm.head_size
            add(f"l{l}.ssd", "attn", l,
                2 * T * d * (2 * d + 2 * H * N) + 6 * T * H * N * cfg.ssm.head_size,
                4 * T * d * bf, model_idle)
        if cfg.encoder_layers:
            add(f"l{l}.cross_attn", "attn", l,
                2 * T * d * (nq + 2 * nkv) * hd + 4 * B * S * S * nq * hd,
                2 * T * d * bf, full)
        add(f"l{l}.norm2", "ffn", l, 5 * T * d, 2 * T * d * 4, full, "alu")
        if cfg.moe is not None:
            e = cfg.moe
            add(f"l{l}.router", "ffn", l, 2 * T * d * e.num_experts,
                T * d * bf, model_idle)
            add(f"l{l}.dispatch", "ffn", l, T * e.top_k * 8,
                2 * T * d * bf, full, "alu")
            mult = 3 if cfg.activation == "swiglu" else 2
            cap = T * e.top_k * e.capacity_factor
            add(f"l{l}.experts", "ffn", l, 2 * cap * d * e.expert_ff * mult,
                cap * (d + e.expert_ff) * bf
                + e.num_experts * mult * d * e.expert_ff * bf, full)
            add(f"l{l}.combine", "ffn", l, T * e.top_k * d,
                2 * T * d * bf, full, "alu")
            if e.dense_residual_ff:
                add(f"l{l}.dense_mlp", "ffn", l,
                    2 * T * d * e.dense_residual_ff * mult,
                    T * d * bf * 2 + mult * d * e.dense_residual_ff * bf, full)
        else:
            mult = 3 if cfg.activation == "swiglu" else 2
            add(f"l{l}.mlp", "ffn", l, 2 * T * d * f * mult,
                T * (2 * d + f) * bf + mult * d * f * bf, full)
    vpad = cfg.vocab_size
    add("lm_head", "head", -1, 2 * T * d * vpad,
        T * d * bf + d * vpad * bf + T * vpad * 4, full)
    return ops


# ------------------------------------------------------------ partitioning
def partition(ops: List[OpNode], mode: str) -> List[Section]:
    if mode == "O0":
        return [Section(o.name, [o]) for o in ops]
    if mode == "O1":
        groups: dict = {}
        for o in ops:
            groups.setdefault(o.module, Section(o.module)).ops.append(o)
        return list(groups.values())
    if mode == "O3":
        groups = {}
        for o in ops:
            key = "pre_post" if o.layer < 0 else f"layer{o.layer}"
            groups.setdefault(key, Section(key)).ops.append(o)
        return list(groups.values())
    raise ValueError(mode)


# ------------------------------------------------------------- reporting
@dataclass
class SectionReport:
    mode: str
    n_sections: int
    allocation: float         # Eq. 2
    load_imbalance: float     # Eq. 3 over sections (+Eq. 4 weighting)
    total_runtime: float

    def to_dict(self):
        return self.__dict__.copy()


def analyze(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshConfig,
            mode: str, chip: Chip = H100,
            dtype: str = "bfloat16") -> SectionReport:
    ops = build_op_graph(cfg, shape, mesh, dtype)
    secs = partition(ops, mode)
    n = mesh.num_devices
    runtimes = [s.runtime(n, chip, dtype) for s in secs]
    alloc = metrics.weighted_allocation(
        [(rt, s.participation, 1.0) for rt, s in zip(runtimes, secs)])
    li = metrics.load_imbalance(
        [s.participation * n for s in secs],
        [s.throughput(n, chip, dtype) for s in secs])
    return SectionReport(mode=mode, n_sections=len(secs), allocation=alloc,
                         load_imbalance=li,
                         total_runtime=float(sum(runtimes)))
