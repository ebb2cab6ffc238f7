"""Elastic re-meshing: the mesh for a healthy device count. The
counterpart of ``repro/runtime/elastic.py``'s ``choose_mesh``; its
``remesh`` (restoring the newest checkpoint resharded onto a new mesh)
is not ported yet.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import MeshConfig


def choose_mesh(n_devices: int, *, prefer_model: int = 0) -> MeshConfig:
    """Best (data, model) split for a device count: keep `model` a power of
    two no larger than prefer_model (or sqrt n), rest data-parallel."""
    if n_devices == 1:
        return MeshConfig(shape=(1, 1), axes=("data", "model"))
    model = prefer_model or 2 ** int(math.log2(max(1, int(n_devices ** 0.5))))
    while n_devices % model:
        model //= 2
    return MeshConfig(shape=(n_devices // model, model),
                      axes=("data", "model"))
