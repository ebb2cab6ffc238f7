"""granite-3-8b [dense] — GQA kv=8. [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    qkv_bias=False,
    norm="rmsnorm",
    activation="swiglu",
    rope="rope",
    rope_theta=1e4,
    tie_embeddings=True,
    notes="Granite-3: GQA kv=8, tied embeddings",
)
