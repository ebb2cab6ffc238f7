"""rwkv6-3b [ssm] — Finch, data-dependent decay, attention-free.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    norm="layernorm",
    activation="rwkv",            # channel-mix (squared-relu gated)
    rope="none",
    attention_kind="none",
    ssm=SSMConfig(kind="rwkv6", head_size=64, chunk_size=64),
    notes="Attention-free; WKV6 data-dependent per-channel decay; constant-size "
          "recurrent state => long_500k decode runs",
)
