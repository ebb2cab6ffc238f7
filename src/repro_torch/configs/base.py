"""Configuration system for the DABench-LLM reproduction (PyTorch port).

A copy of ``repro.configs.base``: the port imports nothing of the JAX
package, and these dataclasses are pure data, so both packages describe
every architecture identically.

ModelConfig describes an architecture (one file per assigned arch in this
package); ShapeConfig describes one of the assigned input-shape cells;
RunConfig binds a model to a shape, a mesh, and execution-policy knobs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int                 # d_ff of each expert
    capacity_factor: float = 1.25
    dense_residual_ff: int = 0     # arctic: dense residual MLP alongside MoE
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    kind: str                      # 'rwkv6' | 'ssd' (mamba-2 style, used by hymba)
    head_size: int = 64
    state_size: int = 16           # ssd: N per head; rwkv6 uses head_size x head_size
    chunk_size: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|audio|vlm|hybrid|ssm
    num_layers: int
    d_model: int
    num_heads: int                 # query heads; 0 for attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    activation: str = "swiglu"     # swiglu | gelu
    rope: str = "rope"             # rope | mrope | sinusoidal | none
    rope_theta: float = 1e6
    attention_kind: str = "full"   # full | sliding | none
    window: int = 0                # sliding-window size (tokens)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder_layers: int = 0        # >0 -> encoder-decoder (whisper)
    frontend: str = "none"         # none | audio_stub | vision_stub
    tie_embeddings: bool = False
    # hymba: fraction of heads that are SSM vs attention happens via ssm!=None
    # and attention_kind == 'sliding'; both branches run in parallel per layer.
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 64

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.attention_kind == "none"

    @property
    def sub_quadratic(self) -> bool:
        """Whether the arch can run the 500k-token decode cell."""
        return self.is_attention_free or (
            self.attention_kind == "sliding" and self.window > 0
        )

    def param_count(self) -> int:
        """Analytic total parameter count (used for 6ND model flops)."""
        d, f, hd = self.d_model, self.d_ff, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        per_layer = 0
        if not self.is_attention_free and self.attention_kind != "none":
            per_layer += d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
            if self.qkv_bias:
                per_layer += (nq + 2 * nkv) * hd
        if self.ssm is not None:
            h = d // self.ssm.head_size
            if self.ssm.kind == "rwkv6":
                # r,k,v,g,w projections + output
                per_layer += 5 * d * d + d * d
            else:  # ssd
                per_layer += d * (2 * d + 2 * h * self.ssm.state_size + h) + d * d
        if self.moe is not None:
            e = self.moe
            per_layer += d * e.num_experts  # router
            mult = 3 if self.activation == "swiglu" else 2
            per_layer += e.num_experts * mult * d * e.expert_ff
            if e.dense_residual_ff:
                per_layer += mult * d * e.dense_residual_ff
        else:
            mult = 3 if self.activation == "swiglu" else 2
            per_layer += mult * d * f
        per_layer += 2 * d  # norms
        total = self.num_layers * per_layer
        if self.encoder_layers:
            # encoder layers: self-attn + mlp; decoder layers add cross-attn
            enc_layer = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
            mult = 3 if self.activation == "swiglu" else 2
            enc_layer += mult * d * f + 2 * d
            total += self.encoder_layers * enc_layer
            # cross attention in each decoder layer
            total += self.num_layers * (d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d + d)
        total += self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        mult = 3 if self.activation == "swiglu" else 2
        all_expert = self.num_layers * e.num_experts * mult * self.d_model * e.expert_ff
        active_expert = self.num_layers * e.top_k * mult * self.d_model * e.expert_ff
        return self.param_count() - all_expert + active_expert


@dataclass(frozen=True)
class ShapeConfig:
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Axes batch shards over (everything named pod/data)."""
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def data_size(self) -> int:
        return int(
            __import__("math").prod(
                s for s, a in zip(self.shape, self.axes) if a in ("pod", "data")
            )
        )

    @property
    def model_size(self) -> int:
        return int(
            __import__("math").prod(
                s for s, a in zip(self.shape, self.axes) if a == "model"
            )
        )


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = MeshConfig()
    # execution policy
    exec_mode: str = "resident"    # resident | streaming (ZeRO-3) | pipeline
    pp_stages: int = 1
    microbatches: int = 1          # gradient-accumulation steps (train)
    remat: bool = True
    attention_backend: str = "chunked"  # dense | chunked | pallas
    attention_chunk: int = 1024
    # Pallas tile overrides (backend='pallas' only). None = auto: the
    # kernels resolve tiles from the tuned-config cache written by
    # `python -m benchmarks.run --tune` (see repro.kernels.tuning).
    attn_block_q: Optional[int] = None
    attn_block_k: Optional[int] = None
    ssm_chunk: Optional[int] = None
    decode_attention: str = "partitioned"  # simple | partitioned (lse-combine)
    # §Perf opt-in flags (baseline keeps all False; see EXPERIMENTS §Perf)
    pin_mixer_output: bool = False   # bf16 TP psum before residual
    ssm_factored: bool = False       # two-level intra-chunk linear attention
    ep_over_pod: bool = False        # shard experts over (pod, model)
    layers_per_block: int = 1        # remat block size (saved stack / k)
    ssm_tp: bool = False             # TP rwkv/ssd projections (reshard wkv)
    norm_local: bool = False         # psum-free device-local norms
    seq_shard: bool = False  # sequence-parallel residual/norm activations
                             # (Megatron-SP): shards (B,S,d) seq over `model`.
                             # Off by default: XLA inserts gather/scatter
                             # thrash around blunt per-layer constraints
                             # (measured 6x collective regression, §Perf).
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    grad_compression: str = "none"  # none | int8
    # optimizer
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    grad_clip: float = 1.0
    opt_state_dtype: str = "float32"   # float32 | bfloat16 | int8 (blockwise)
    opt_master: bool = True            # keep f32 master copy
    grad_accum_dtype: str = "float32"
    seed: int = 0

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 128,
            vocab: int = 512, d_ff: int = 256, experts: int = 4,
            window: int = 64) -> ModelConfig:
    """Shrink a full architecture config to a CPU-smoke-testable size,
    preserving its structural family (GQA ratio, MoE, SSM, enc-dec, ...)."""
    nq = max(1, min(cfg.num_heads, 4)) if cfg.num_heads else 0
    nkv = max(1, min(cfg.num_kv_heads, nq)) if cfg.num_kv_heads else 0
    if nq and nkv:
        while nq % nkv:
            nkv -= 1
    hd = d_model // nq if nq else 32
    kw: dict = dict(
        name=cfg.name + "-reduced",
        num_layers=layers,
        d_model=d_model,
        num_heads=nq,
        num_kv_heads=nkv,
        head_dim=hd,
        d_ff=d_ff,
        vocab_size=vocab,
        window=min(cfg.window, window) if cfg.window else 0,
        encoder_layers=min(cfg.encoder_layers, layers),
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=experts,
            expert_ff=d_ff,
            dense_residual_ff=d_ff if cfg.moe.dense_residual_ff else 0,
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, head_size=hd if cfg.ssm.kind == "rwkv6" else 32,
            chunk_size=16)
    return dataclasses.replace(cfg, **kw)
