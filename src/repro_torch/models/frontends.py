"""Modality-frontend stubs and input specs, the PyTorch counterpart of
``repro/models/frontends.py``.

The audio (whisper) and vision (qwen2-vl, llama4's early fusion) entries
specify the transformer backbone only: the conv/mel and patch-embedding
frontends are stubs, and the backbone takes precomputed frame or patch
embeddings. The embeddings are bf16 made from numpy float64 samples,
rounded as the reference rounds them (:func:`bf16_from_numpy`), so the
same seed gives the same bits in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def bf16_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy float array as a bf16 tensor, rounded to nearest even
    through f32 as ``jnp.asarray(a, jnp.bfloat16)`` rounds float64 (twice:
    to f32, then to bf16)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def train_batch_spec(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """{name: (shape, dtype)} for one training batch."""
    spec: dict = {}
    if cfg.frontend == "vision_stub":
        spec["embeds"] = ((batch, seq, cfg.d_model), torch.bfloat16)
        if cfg.rope == "mrope":
            spec["positions"] = ((batch, 3, seq), torch.int32)
    elif cfg.frontend == "audio_stub":
        spec["audio_embeds"] = ((batch, seq, cfg.d_model), torch.bfloat16)
        spec["tokens"] = ((batch, seq), torch.int32)
    else:
        spec["tokens"] = ((batch, seq), torch.int32)
    spec["labels"] = ((batch, seq), torch.int32)
    return spec


def prefill_batch_spec(cfg: ModelConfig, batch: int, seq: int) -> dict:
    spec = train_batch_spec(cfg, batch, seq)
    spec.pop("labels")
    return spec


def synth_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                kind: str = "train", device="cpu") -> dict:
    """Deterministic synthetic batch matching the spec (smoke and bench
    use): integers uniform below the vocab (tokens, labels) or ``seq``
    (positions), embeddings N(0, 0.02^2); the reference's values, in the
    spec's order from one ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    spec = (train_batch_spec if kind == "train" else prefill_batch_spec)(
        cfg, batch, seq)
    out = {}
    for name, (shape, dtype) in spec.items():
        if dtype == torch.int32:
            hi = cfg.vocab_size if name in ("tokens", "labels") else seq
            t = torch.from_numpy(rng.integers(0, hi, size=shape)
                                 .astype(np.int32))
        else:
            t = bf16_from_numpy(rng.standard_normal(shape) * 0.02)
        out[name] = t.to(device)
    return out
