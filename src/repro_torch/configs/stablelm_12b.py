"""stablelm-12b [dense] — GQA kv=8. [hf:stabilityai/stablelm-2-1_6b; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    qkv_bias=False,
    norm="layernorm",
    activation="swiglu",
    rope="rope",
    rope_theta=1e4,
    notes="StableLM-2 family: LayerNorm, GQA kv=8",
)
