"""Step builders: the training step (microbatched gradient accumulation +
AdamW) and the decode step, the PyTorch counterpart of
``repro/runtime/steps.py``, on one device or over a mesh.

Over a mesh (``mesh=``, a ``DeviceMesh`` of ``rcfg.mesh``; see
:mod:`repro_torch.launch.mesh`) each rank holds its shards of the params
and of the AdamW state (:func:`repro_torch.parallel.sharding.shard_tree`
of ``param_pspecs``) and takes the whole global batch, of which it
computes its rows. The step's metrics equal the one-device step's.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import RunConfig
from repro_torch.models import Runtime, build
from repro_torch.models.model import abstract_params
from repro_torch.models.transformer import num_layers_of
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.train_loop import UpdateFailed


def make_runtime(rcfg: RunConfig, *, for_decode: bool = False,
                 mesh=None) -> Runtime:
    """The knobs of ``rcfg`` the port has: the attention backend
    ('kernel' or 'dense'), remat and its block size, and ``ssm_factored``.
    The ssm backend is pinned to the plain ``chunked`` form, as the
    reference's training step pins it: kernel B6 has no backward.

    With ``mesh``: the mesh fields as the reference sets them (the batch
    axes of a microbatch, their size, expert parallelism over ``model``
    or ``(pod, model)`` where the MoE meets more than one device), the
    mesh itself and the parameters' specs."""
    rt = Runtime(attention_backend=rcfg.attention_backend,
                 ssm_backend="chunked", ssm_factored=rcfg.ssm_factored,
                 remat=rcfg.remat, layers_per_block=rcfg.layers_per_block)
    if mesh is None:
        return rt
    if (tuple(mesh.shape), tuple(mesh.mesh_dim_names)) != (
            tuple(rcfg.mesh.shape), tuple(rcfg.mesh.axes)):
        raise ValueError(f"the mesh {tuple(mesh.shape)} over "
                         f"{tuple(mesh.mesh_dim_names)} is not the run's "
                         f"{rcfg.mesh}: the specs follow the run's")
    gb = rcfg.shape.global_batch
    mb = (max(1, gb // max(rcfg.microbatches, 1))
          if rcfg.shape.kind == "train" and not for_decode else gb)
    excl = ("pod",) if rcfg.ep_over_pod else ()
    bspec = shd.batch_spec(rcfg.mesh, mb, excl) or ()
    sizes = shd.axis_sizes(rcfg.mesh)
    specs = shd.param_pspecs(
        abstract_params(rcfg.model, getattr(torch, rcfg.param_dtype)),
        rcfg.model, rcfg)
    return dataclasses.replace(
        rt, mesh_batch_axes=tuple(bspec),
        dp_size=math.prod(sizes[a] for a in bspec),
        moe_shardmap=(rcfg.model.moe is not None
                      and rcfg.mesh.num_devices > 1),
        ep_axes=("pod", "model") if rcfg.ep_over_pod else ("model",),
        mesh=mesh, param_specs=specs)


def make_model(rcfg: RunConfig, *, device="cuda", mesh=None,
               for_decode: bool = False):
    return build(rcfg.model, make_runtime(rcfg, for_decode=for_decode,
                                          mesh=mesh),
                 param_dtype=getattr(torch, rcfg.param_dtype),
                 device=device)


def make_optimizer(rcfg: RunConfig, total_steps: int = 10000) -> AdamW:
    return AdamW(lr_fn=warmup_cosine(rcfg.learning_rate, rcfg.warmup_steps,
                                     total_steps),
                 weight_decay=rcfg.weight_decay, grad_clip=rcfg.grad_clip,
                 state_dtype=rcfg.opt_state_dtype,
                 use_master=rcfg.opt_master)


def _grad_leaves(params, gsum):
    """The tree autograd differentiates, and the accumulator each of its
    leaves' gradients adds into. Every parameter is detached into a leaf
    of its own, and each layer's slice of a stacked (L, ...) parameter is
    a separate leaf (a view of the same storage), in a list of per-layer
    trees: a layer's gradient then lands in a tensor of the layer's size,
    where through the stacked tensor each layer's slice would give back a
    zero-filled gradient of the whole stack. An encoder-decoder model's
    encoder stack (``enc_layers``) is split the same way. Returns (tree,
    [(leaf, accumulator)])."""
    pairs = []

    def leaf(a, acc):
        t = a.detach().requires_grad_()
        pairs.append((t, acc))
        return t

    stacks = ("layers", "enc_layers")     # the decoder's and encoder's
    tree = {k: tree_map(leaf, v, gsum[k]) for k, v in params.items()
            if k not in stacks}
    for k in stacks:
        if k in params:
            tree[k] = [tree_map(lambda a, acc: leaf(a[i], acc[i]), params[k],
                                gsum[k])
                       for i in range(num_layers_of(params[k]))]
    return tree, pairs


def accumulate_grads(model, params, batch, microbatches: int,
                     acc_dtype=torch.float32):
    """The gradients of ``model.loss`` over ``batch`` split into
    ``microbatches`` consecutive microbatches, summed in ``acc_dtype`` and
    divided by their number, the mean loss, and the moe family's router
    statistics: (grads, a tree like ``params``; loss, a device scalar;
    stats, {} or the mean ``aux_loss`` and the ``expert_load`` (L, E)
    summed over the microbatches). The MoE's ``aux_loss`` is part of the
    loss, so it reaches the gradients. Touches neither ``params`` nor
    anything else."""
    gb = batch["labels"].shape[0]
    if gb % microbatches:
        raise ValueError(f"global batch {gb} does not split into "
                         f"{microbatches} microbatches")
    mb = gb // microbatches
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                          device=p.device), params)
    losses, aux_losses, loads = [], [], []
    for i in range(microbatches):
        mbatch = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        tree, pairs = _grad_leaves(params, gsum)
        loss, aux = model.loss(tree, mbatch)
        # a leaf the loss does not reach (the token table under the vision
        # stub's embeds) has no gradient: its accumulator stays 0, the
        # reference's zero gradient
        grads = torch.autograd.grad(loss, [t for t, _ in pairs],
                                    allow_unused=True)
        for (_, acc), g in zip(pairs, grads):
            if g is not None:
                acc.add_(g.to(acc_dtype))
        del tree, pairs, grads
        losses.append(loss.detach())
        if "expert_load" in aux:
            aux_losses.append(aux["aux_loss"].detach())
            loads.append(aux["expert_load"])
    for g in tree_leaves(gsum):
        g.div_(microbatches)
    stats = {}
    if loads:
        stats = {"aux_loss": torch.stack(aux_losses).mean(),
                 "expert_load": torch.stack(loads).sum(0)}
    return gsum, torch.stack(losses).mean(), stats


def local_rows(batch: dict, microbatches: int, mesh, axes) -> dict:
    """This rank's rows of the global ``batch``: of each of its
    ``microbatches`` consecutive microbatches, the block of the batch
    shard it holds over ``axes`` (its index over them, the first axis
    outermost), concatenated, so that :func:`accumulate_grads` splits
    them into the same microbatches."""
    gb = batch["labels"].shape[0]
    mb = gb // microbatches
    n, idx = coll.axis_size(mesh, axes), coll.axis_index(mesh, axes)
    rows = mb // n
    picks = [slice(i * mb + idx * rows, i * mb + (idx + 1) * rows)
             for i in range(microbatches)]
    return {k: torch.cat([v[s] for s in picks]) for k, v in batch.items()}


def average_over_data(grads, specs, mesh, data_axes) -> None:
    """Turn each rank's gradients of its rows into the mean over every
    data shard, IN PLACE: a leaf sums over the data axes its shard does
    not split (a leaf split over ``data`` was summed over it by its
    gather's reduce-scatter), then divides by their product."""
    n = coll.axis_size(mesh, data_axes)
    for g, spec in shd.leaf_specs(grads, specs):
        axes = tuple(a for a in data_axes if a not in spec.axes())
        group = coll.group_of(mesh, axes)
        if group is not None:
            coll.call(dist.all_reduce, g, group=group)
        g.div_(n)


def sharded_global_norm(grads, specs, mesh) -> torch.Tensor:
    """The global norm of gradients held as shards: each leaf's sum of
    squares summed over the axes its shard splits (its replicas over the
    others count once), in f32."""
    by_axes: dict = {}
    for g, spec in shd.leaf_specs(grads, specs):
        axes = tuple(a for a in mesh.mesh_dim_names if a in spec.axes())
        sq = torch.sum(torch.square(g.float()))
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    total = sum(coll.all_reduce(sq, mesh, axes) if axes else sq
                for axes, sq in by_axes.items())
    return torch.sqrt(total)


def build_train_step(rcfg: RunConfig, total_steps: int = 10000, *,
                     device="cuda", mesh=None):
    """Returns (train_step, model, optimizer). train_step signature:
    (params, opt_state, batch) -> (params, opt_state, metrics).

    The batch carries the full global batch; gradient accumulation splits
    its rows into ``rcfg.microbatches`` consecutive microbatches, sums
    their gradients in ``rcfg.grad_accum_dtype``, divides by their number
    and reports the mean loss, as the reference does. For the moe family
    the metrics also hold the step's mean ``aux_loss`` and its
    ``expert_load`` ((L, E), summed over the microbatches).

    The step updates ``params`` and ``opt_state`` IN PLACE and returns the
    same objects. It computes every gradient before it touches either, so
    a step that raises before its update leaves them as they were (the
    loop may retry it); a failure inside the update raises
    :class:`~repro_torch.runtime.train_loop.UpdateFailed`. A step whose
    loss is not finite skips its update. It returns once the device has
    finished the step, as reading the reference's jitted step's loss
    does, so a host clock around it times the whole step.

    With ``mesh``, params and opt_state are this rank's shards, and the
    batch the whole global batch: the rank computes its rows of each
    microbatch (the batch axes of ``batch_spec``), the gradients are
    averaged over the data axes (under ``exec_mode="streaming"`` those of
    the data-sharded weights come reduce-scattered from their gathers),
    the loss is averaged, the gradient norm is taken over the shards, and
    AdamW updates the local shards only.
    """
    model = make_model(rcfg, device=device, mesh=mesh)
    opt = make_optimizer(rcfg, total_steps)
    n_mb = max(1, rcfg.microbatches)
    acc_dt = getattr(torch, rcfg.grad_accum_dtype)
    rt = model.rt
    data_axes = rcfg.mesh.data_axes

    def gradients(params, batch):
        """The step up to its update: (gradients, loss, router stats,
        the sharded gradient norm or None)."""
        gnorm = None
        if mesh is None:
            gsum, loss, stats = accumulate_grads(model, params, batch, n_mb,
                                                 acc_dt)
        else:
            batch = local_rows(batch, n_mb, mesh, rt.mesh_batch_axes)
            gsum, loss, stats = accumulate_grads(model, params, batch, n_mb,
                                                 acc_dt)
            average_over_data(gsum, rt.param_specs, mesh, data_axes)
            loss = coll.all_reduce(loss, mesh, data_axes) / \
                coll.axis_size(mesh, data_axes)
            gnorm = sharded_global_norm(gsum, rt.param_specs, mesh)
        return gsum, loss, stats, gnorm

    def train_step(params, opt_state, batch):
        gsum, loss, stats, gnorm = gradients(params, batch)
        metrics = {"loss": loss, **stats}
        if not torch.isfinite(loss):       # the loop skips this step
            return params, opt_state, metrics
        try:
            params, opt_state, m = opt.update(gsum, opt_state, params,
                                              gnorm=gnorm)
            # inside the try: an asynchronous error of the update's
            # kernels shows here, after its first in-place write
            if loss.is_cuda:
                torch.cuda.synchronize(loss.device)
        except Exception as e:
            raise UpdateFailed(f"optimizer update failed: {e}") from e
        metrics.update(m)
        return params, opt_state, metrics

    # the part before the update, for a count without the host's reads
    # of the device (the dry run on ``meta``)
    train_step.gradients = gradients
    return train_step, model, opt


def build_decode_step(rcfg: RunConfig, *, device="cuda", mesh=None,
                      ssm_backend: str = "chunked"):
    """Returns (decode_step, model). The decode attention is partitioned
    (over a sequence-sharded cache, combined across ``model``) where the
    reference partitions it: ``decode_attention="partitioned"``, full
    attention, and a sequence length the model axis divides. The model's
    prefill lays its caches out for this decode step, its ssm mixes in
    the ``ssm_backend`` form ("kernel": B6)."""
    part = (rcfg.decode_attention == "partitioned"
            and rcfg.model.attention_kind == "full"
            and rcfg.shape.seq_len % rcfg.mesh.model_size == 0)
    bspec = shd.batch_spec(rcfg.mesh, rcfg.shape.global_batch) or ()
    rt = dataclasses.replace(make_runtime(rcfg, for_decode=True, mesh=mesh),
                             decode_partitioned=part,
                             mesh_batch_axes=tuple(bspec),
                             ssm_backend=ssm_backend)
    model = build(rcfg.model, rt, param_dtype=getattr(torch, rcfg.param_dtype),
                  device=device)
    return model.decode_step, model
