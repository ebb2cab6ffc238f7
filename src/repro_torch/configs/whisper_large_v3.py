"""whisper-large-v3 [audio] — enc-dec, conv frontend (stub). [arXiv:2212.04356; unverified]

The assignment specifies the transformer backbone only (32L d_model=1280 20H
d_ff=5120); the conv/mel frontend is a stub — input_specs() provides
precomputed frame embeddings. Whisper-large has 32 encoder + 32 decoder
layers; we honour the enc-dec structure with 32 of each.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,            # decoder layers
    encoder_layers=32,        # encoder layers (bidirectional attention)
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,          # MHA (kv == q heads)
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    qkv_bias=True,
    norm="layernorm",
    activation="gelu",
    rope="sinusoidal",
    frontend="audio_stub",
    tie_embeddings=True,
    notes="Enc-dec; conv frontend stubbed (precomputed frame embeddings)",
)
