"""hymba-1.5b [hybrid] — parallel attn + mamba heads, sliding window.
[arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    qkv_bias=False,
    norm="rmsnorm",
    activation="swiglu",
    rope="rope",
    rope_theta=1e4,
    attention_kind="sliding",
    window=1024,
    ssm=SSMConfig(kind="ssd", head_size=64, state_size=16, chunk_size=64),
    notes="Parallel attention + Mamba(SSD) heads per layer; sliding window "
          "keeps the KV cache O(window) so long_500k runs",
)
