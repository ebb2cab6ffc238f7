"""Training launcher of the port:
``python -m repro_torch.launch.train --arch <id> [...]`` -- trains on the
CUDA device through :func:`repro_torch.runtime.steps.build_train_step`
and :func:`repro_torch.runtime.train_loop.run`, on synthetic batches.

The flags are those of ``repro.launch.train`` (the reduced config by
default, ``--full`` for the full-size architecture), plus
``--num-layers`` (cut the depth of a ``--full`` run: one card holds the
f32 params, gradients, master copy and AdamW moments of about 8 of
granite-3-8b's 40 layers). Attention runs through the hand kernels.
``--ckpt-dir DIR`` resumes from the newest committed checkpoint in DIR
and saves one every ``--ckpt-every`` steps and after the last
(:mod:`repro_torch.checkpoint.checkpoint`). The launcher trains in f32,
as the reference's pins it; :func:`build_trainer` takes ``param_dtype``
("bfloat16": bf16 params with an f32 master copy, f32 moments and f32
gradient sums).

Under ``torchrun`` the launcher takes the world from the environment and
trains over the mesh :func:`repro_torch.runtime.elastic.choose_mesh`
picks for it, as the reference's launcher does for its devices (one
rank a card, NCCL)::

    PYTHONPATH=src torchrun --standalone --nproc-per-node N \
        -m repro_torch.launch.train --arch granite-3-8b --full \
        --num-layers 8 --batch 8 --seq 4096 --steps 3

Each rank holds its shards of the params and the AdamW state; only rank
0 prints. ``--ckpt-dir`` saves the full logical leaves (rank 0 writes)
and resumes each rank's shards from them, on whatever mesh the new world
gets (:func:`repro_torch.runtime.elastic.remesh`'s restore).
``--device cpu`` runs the ranks on gloo (tests).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os

import numpy as np
import torch

from repro_torch.configs import (MeshConfig, RunConfig, ShapeConfig,
                                 get_arch, reduced)
from repro_torch.core.metrics import expert_load_imbalance
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import resolve_device
from repro_torch.parallel.sharding import shard_tree
from repro_torch.runtime import train_loop
from repro_torch.runtime.elastic import choose_mesh, train_state_specs
from repro_torch.runtime.steps import build_train_step


def build_trainer(arch: str, *, steps: int, batch: int, seq: int,
                  use_reduced: bool = True, reduce_kw=None,
                  num_layers: int = 0, microbatches: int = 1,
                  lr: float = 3e-4, param_dtype: str = "float32",
                  device="cuda", mesh=None, exec_mode: str = "resident"):
    """The launcher's plumbing, importable so tests and ``chip_smoke.py``
    share it: params of ``param_dtype`` (f32 by default, as the reference
    launcher pins it) from a seeded ``torch.Generator`` on ``device``,
    their AdamW state (an f32 master copy and f32 moments), and the step
    and data of the reference launcher's run config. In bf16 the leaves
    the reference's init keeps in f32 stay f32: every norm's scale (and
    bias) and, in the moe family, the router. With ``mesh`` (a
    ``DeviceMesh`` of this process group), params and their state are
    this rank's shards and the step the sharded one (``exec_mode``:
    "resident", or "streaming" for ZeRO-3); the data is the whole global
    batch. Returns (train_step,
    params, opt_state, data, rcfg)."""
    cfg = get_arch(arch)
    if use_reduced:
        cfg = reduced(cfg, **(reduce_kw or {}))
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    device = resolve_device(device)
    mesh_kw = {} if mesh is None else {"mesh": MeshConfig(
        shape=tuple(mesh.shape), axes=tuple(mesh.mesh_dim_names))}
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("custom", "train", seq,
                                                  batch), **mesh_kw,
                     microbatches=microbatches, attention_backend="kernel",
                     learning_rate=lr, param_dtype=param_dtype,
                     exec_mode=exec_mode,
                     warmup_steps=max(10, steps // 10))
    step_fn, model, opt = build_train_step(rcfg, total_steps=steps,
                                           device=device, mesh=mesh)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(rcfg.seed))
    if mesh is not None:
        params = shard_tree(params, model.rt.param_specs, mesh)
    opt_state = opt.init(params)
    data = SyntheticLM(cfg, batch, seq, seed=rcfg.seed, device=str(device))
    return step_fn, params, opt_state, data, rcfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--layers", type=int, default=4,
                    help="layers of the reduced config")
    ap.add_argument("--d-model", type=int, default=256,
                    help="width of the reduced config")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the depth of the (full or reduced) config "
                         "to this many layers (0 = keep it)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    mesh, rank = None, 0
    if "WORLD_SIZE" in os.environ:          # torchrun: one rank a card
        import torch.distributed as dist

        from repro_torch.launch.mesh import init_world, make_mesh
        init_world(args.device)
        rank = dist.get_rank()
        mesh = make_mesh(choose_mesh(dist.get_world_size()), args.device)
    step_fn, params, opt_state, data, rcfg = build_trainer(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        use_reduced=args.reduced,
        reduce_kw=dict(layers=args.layers, d_model=args.d_model),
        num_layers=args.num_layers, microbatches=args.microbatches,
        lr=args.lr, mesh=mesh, device=args.device)
    sharding = None
    if mesh is not None and args.ckpt_dir:
        sharding = (train_state_specs(rcfg)[0], mesh)
    result = train_loop.run(step_fn, params, opt_state, data.batch_at,
                            total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                            ckpt_every=args.ckpt_every, sharding=sharding)
    if rank:
        return result
    for i, m in enumerate(result.metrics):
        if i % args.log_every == 0 or i == len(result.metrics) - 1:
            moe = ""
            if "expert_load" in m:     # the moe family's router statistics
                li = expert_load_imbalance(np.sum(m["expert_load"], 0))
                moe = (f"aux_loss={m['aux_loss']:.5f} "
                       f"expert_load_LI={li:.4f} ")
            print(f"  step {i}: loss={m['loss']:.4f} "
                  f"grad_norm={m['grad_norm']:.4f} {moe}"
                  f"step_s={m['step_s']:.3f}")
    print(f"final_step={result.final_step} "
          f"first_loss={result.losses[0]:.4f} "
          f"last_loss={result.losses[-1]:.4f} "
          f"resumed_from={result.resumed_from} retries={result.retries} "
          f"stragglers={result.stragglers}")
    return result


if __name__ == "__main__":
    main()
