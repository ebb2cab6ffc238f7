"""Elastic re-meshing: survive a change in the healthy device count. The
counterpart of ``repro/runtime/elastic.py``.

Protocol (what a fleet controller would drive):
1. detect the device-count change (a node died, capacity returned);
2. pick the best mesh for the new count (:func:`choose_mesh`);
3. start a process group of the new count, build the mesh and restore the
   last committed checkpoint onto it (:func:`remesh`): each rank copies
   its own block of every full logical leaf out of the saved files;
4. resume the deterministic data stream at the restored step.

Checkpoints hold full logical leaves (a sharded run gathers them as it
saves, :func:`repro_torch.checkpoint.checkpoint.save`), so 8 -> 4 or 4 ->
8 ranks is a pure data-placement change.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import MeshConfig, RunConfig


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


def _local_like(tree, specs, mesh, device):
    """Zeroed tensors of this rank's shards of a tree of full logical
    leaves (``meta`` ones do: only shapes and dtypes are read)."""
    from repro_torch.optim.adamw import Q8, AdamWState
    from repro_torch.parallel.sharding import _entry_shards

    if isinstance(tree, dict):
        return {k: _local_like(v, specs[k], mesh, device)
                for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(step=tree.step, **{
            f: _local_like(getattr(tree, f), getattr(specs, f), mesh, device)
            for f in ("master", "m", "v")})
    if isinstance(tree, Q8):
        return Q8(q=_local_like(tree.q, specs.q, mesh, device),
                  scale=_local_like(tree.scale, specs.scale, mesh, device))
    shape = [size // _entry_shards(mesh, specs[d] if d < len(specs)
                                   else None)[0]
             for d, size in enumerate(tree.shape)]
    return torch.zeros(shape, dtype=tree.dtype, device=device)


def remesh(ckpt_dir: str, step_tree_template, new_mesh_cfg: MeshConfig,
           specs, device="cuda") -> Tuple[object, dict]:
    """Build the new mesh (over the ranks of this process group, NCCL on
    ``cuda``, gloo on ``cpu``) and restore the latest checkpoint onto it.
    ``step_tree_template``: the full logical tree (shapes and dtypes;
    ``meta`` tensors do), ``specs``: its spec tree. Each rank's shards are
    made on ``device`` and filled from the files on the host. Returns
    (mesh, {"step": the restored step or None, "tree": this rank's
    shards})."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch.mesh import make_mesh

    kind = torch.device(device).type
    mesh = make_mesh(new_mesh_cfg, kind)
    if kind == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    local = _local_like(step_tree_template, specs, mesh, device)
    step, tree = ckpt.restore_latest(ckpt_dir, local, specs=specs, mesh=mesh)
    return mesh, {"step": step, "tree": tree}


def train_state_specs(rcfg: RunConfig):
    """The spec tree of a sharded training run's checkpointed state,
    ``{"params": ..., "opt": ...}``, on ``rcfg.mesh``, and the state's
    full logical tree on ``meta`` (the template :func:`remesh` takes)."""
    from repro_torch.models.model import abstract_params
    from repro_torch.parallel.sharding import (opt_state_shardings,
                                               param_pspecs)
    from repro_torch.runtime.steps import make_optimizer

    params = abstract_params(rcfg.model, getattr(torch, rcfg.param_dtype))
    opt_state = make_optimizer(rcfg).init(params)
    pspecs = param_pspecs(params, rcfg.model, rcfg)
    specs = {"params": pspecs,
             "opt": opt_state_shardings(opt_state, pspecs, rcfg.mesh)}
    return specs, {"params": params, "opt": opt_state}
