"""Step builders: the training step (microbatched gradient accumulation +
AdamW), the PyTorch counterpart of ``repro/runtime/steps.py`` for what the
port has (one device, no mesh).
"""
from __future__ import annotations

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import RunConfig
from repro_torch.models import Runtime, build
from repro_torch.models.transformer import num_layers_of
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.runtime.train_loop import UpdateFailed


def make_runtime(rcfg: RunConfig) -> Runtime:
    """The knobs of ``rcfg`` the port has: the attention backend
    ('kernel' or 'dense'), remat and its block size, and ``ssm_factored``.
    The ssm backend is pinned to the plain ``chunked`` form, as the
    reference's training step pins it: kernel B6 has no backward."""
    return Runtime(attention_backend=rcfg.attention_backend,
                   ssm_backend="chunked", ssm_factored=rcfg.ssm_factored,
                   remat=rcfg.remat,
                   layers_per_block=rcfg.layers_per_block)


def make_model(rcfg: RunConfig, *, device="cuda"):
    return build(rcfg.model, make_runtime(rcfg),
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


def build_train_step(rcfg: RunConfig, total_steps: int = 10000, *,
                     device="cuda"):
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
    """
    model = make_model(rcfg, device=device)
    opt = make_optimizer(rcfg, total_steps)
    n_mb = max(1, rcfg.microbatches)
    acc_dt = getattr(torch, rcfg.grad_accum_dtype)

    def train_step(params, opt_state, batch):
        gsum, loss, stats = accumulate_grads(model, params, batch, n_mb,
                                             acc_dt)
        metrics = {"loss": loss, **stats}
        if not torch.isfinite(loss):       # the loop skips this step
            return params, opt_state, metrics
        try:
            params, opt_state, m = opt.update(gsum, opt_state, params)
            # inside the try: an asynchronous error of the update's
            # kernels shows here, after its first in-place write
            if loss.is_cuda:
                torch.cuda.synchronize(loss.device)
        except Exception as e:
            raise UpdateFailed(f"optimizer update failed: {e}") from e
        metrics.update(m)
        return params, opt_state, metrics

    return train_step, model, opt
