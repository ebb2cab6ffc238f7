"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

Backbone only; the vision patch-embedding frontend is a stub — input_specs()
provides precomputed patch embeddings plus 3-component (t,h,w) M-RoPE
position ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    norm="rmsnorm",
    activation="swiglu",
    rope="mrope",
    rope_theta=1e6,
    frontend="vision_stub",
    notes="M-RoPE sections (t=16,h=24,w=24) over half head_dim; vision stub",
)
