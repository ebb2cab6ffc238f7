"""qwen1.5-110b [dense] — QKV bias, GQA kv=8. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    norm="rmsnorm",
    activation="swiglu",
    rope="rope",
    rope_theta=1e6,
    notes="Qwen1.5 flagship: 80L, QKV bias, GQA kv=8",
)
