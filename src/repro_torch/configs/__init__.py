"""Architecture registry: --arch <id> resolves here."""
from repro_torch.configs.base import (
    MeshConfig,
    ModelConfig,
    MoEConfig,
    RunConfig,
    ShapeConfig,
    SHAPES,
    SSMConfig,
    reduced,
)

from repro_torch.configs.qwen2_5_32b import CONFIG as _qwen25_32b
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm_12b
from repro_torch.configs.granite_3_8b import CONFIG as _granite_3_8b
from repro_torch.configs.qwen1_5_110b import CONFIG as _qwen15_110b
from repro_torch.configs.llama4_maverick import CONFIG as _llama4
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.qwen2_vl_72b import CONFIG as _qwen2vl
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _qwen25_32b,
        _stablelm_12b,
        _granite_3_8b,
        _qwen15_110b,
        _llama4,
        _arctic,
        _whisper,
        _qwen2vl,
        _hymba,
        _rwkv6,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cells() -> list[tuple[ModelConfig, ShapeConfig]]:
    """All (arch x shape) cells, excluding noted long_500k skips
    (full-attention archs; see DESIGN.md §Shape-matrix skips)."""
    out = []
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not arch.sub_quadratic:
                continue
            out.append((arch, shape))
    return out


__all__ = [
    "ARCHS", "SHAPES", "MeshConfig", "ModelConfig", "MoEConfig", "RunConfig",
    "ShapeConfig", "SSMConfig", "cells", "get_arch", "reduced",
]
