"""Parameters from the JAX package into the port.

The port keeps the JAX parameter layout (the same nested dict names, a
leading stacked-layer axis, ``x @ W`` with ``W`` shaped ``(d_in, d_out)``),
so a JAX parameter tree converts leaf by leaf, with no transposes. The
tree arrives as numpy arrays — ``jax.tree.map(np.asarray, params)`` on the
JAX side — because the port never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._tree import tree_map


def _leaf(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a)     # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":      # ml_dtypes.bfloat16, numpy has none
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device) -> dict:
    """Nested dict of numpy arrays (or tensors) -> the same tree of
    tensors on ``device``, values and dtypes unchanged."""
    device = torch.device(device)
    return tree_map(lambda a: _leaf(a, device), tree)
