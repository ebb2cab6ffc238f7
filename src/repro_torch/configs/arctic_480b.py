"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    qkv_bias=False,
    norm="rmsnorm",
    activation="swiglu",
    rope="rope",
    rope_theta=1e4,
    moe=MoEConfig(num_experts=128, top_k=2, expert_ff=4864,
                  capacity_factor=1.25, dense_residual_ff=4864),
    notes="Dense-MoE hybrid: every layer = dense residual MLP + 128e top-2 MoE",
)
