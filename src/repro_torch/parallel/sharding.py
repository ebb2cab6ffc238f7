"""Sharding rules: map every parameter, cache and batch leaf to a spec,
and cut full tensors to one rank's shards. The counterpart of
``repro/parallel/sharding.py``, under the same names and the same rules.

Two execution modes (the paper's Cerebras whole-graph-resident and
weight-streaming modes):

* ``resident``  -- weights sharded over ``model`` only (TP), replicated
  over the data axes;
* ``streaming`` -- FSDP x TP: weights also shard their contraction dim
  over ``data`` (ZeRO-3); each layer gathers its weights over ``data``
  where it runs (:func:`repro_torch.parallel.collectives.gather_data`).

Heads that do not divide the model axis (rwkv6's d -> H*hs reshape,
hymba's 25 SSD heads) keep their projections replicated over ``model``.

A spec is a :class:`P`: one entry per dimension, each a mesh axis name,
a tuple of names, or ``None``. Like JAX's ``PartitionSpec`` it stores a
one-name tuple as the bare name and an empty tuple as ``None``, so the
two compare equal entry by entry.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MeshConfig, ModelConfig, RunConfig


class P(tuple):
    """A partition spec: one mesh axis (or tuple of axes, or None) per
    dimension."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis this spec shards over, in order."""
        out = []
        for e in self:
            if e is not None:
                out.extend(e if isinstance(e, tuple) else (e,))
        return tuple(out)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def axis_sizes(mesh_cfg: MeshConfig) -> Dict[str, int]:
    return dict(zip(mesh_cfg.axes, mesh_cfg.shape))


def batch_axes(mesh_cfg: MeshConfig) -> Tuple[str, ...]:
    return mesh_cfg.data_axes  # ('pod','data') or ('data',)


def batch_spec(mesh_cfg: MeshConfig, global_batch: int,
               exclude: Tuple[str, ...] = ()) -> Optional[Tuple]:
    """Axes to shard the batch dim over, honoring divisibility. `exclude`
    removes axes repurposed elsewhere (e.g. 'pod' under EP-over-pod)."""
    axes = []
    size = 1
    for a in batch_axes(mesh_cfg):
        if a in exclude:
            continue
        s = axis_sizes(mesh_cfg)[a]
        if global_batch % (size * s) == 0:
            axes.append(a)
            size *= s
    return tuple(axes) if axes else None


def act_pspec(mesh_cfg: MeshConfig, global_batch: int,
              exclude: Tuple[str, ...] = ()) -> P:
    """(B, S, d) activation spec."""
    return P(batch_spec(mesh_cfg, global_batch, exclude), None, None)


def _divisible(n: int, mesh_cfg: MeshConfig, axis: str) -> bool:
    return n % axis_sizes(mesh_cfg)[axis] == 0


def param_pspecs(params_shape, cfg: ModelConfig, rcfg: RunConfig):
    """Spec tree matching the params tree (leaves need only ``.shape``:
    tensors on the ``meta`` device do, see
    :func:`repro_torch.models.model.abstract_params`)."""
    mesh_cfg = rcfg.mesh
    fsdp = "data" if rcfg.exec_mode == "streaming" else None

    def rule(names, leaf):
        name = names[-1]
        in_moe = "moe" in names and "dense" not in names
        in_ssm = "time_mix" in names or "channel_mix" in names or "ssm" in names
        stacked = names[0] in ("layers", "enc_layers")
        L = (None,) if stacked else ()
        nd = len(leaf.shape)

        def spec(*rest):
            if len(L) + len(rest) != nd:
                raise ValueError(
                    f"partition spec rank mismatch for {list(names)}: leaf "
                    f"shape {tuple(leaf.shape)} vs spec {L + rest}")
            return P(*L, *rest)

        # ---- embedding ----
        if names[0] == "embed":
            if name == "tok":
                vshard = "model" if _divisible(leaf.shape[0], mesh_cfg,
                                               "model") else None
                return P(vshard, fsdp)
            if name == "head":
                vshard = "model" if _divisible(leaf.shape[1], mesh_cfg,
                                               "model") else None
                return P(fsdp, vshard)
        # ---- norms / scalars / vectors ----
        if nd - len(L) <= 1 or name in ("mix", "u", "ln_scale", "ln_bias",
                                        "w0", "dt_bias", "A_log", "D"):
            if name in ("bq", "bk", "bv") and not in_ssm:
                return spec("model")
            return P(*((None,) * nd))
        # ---- MoE ----
        if in_moe:
            ep = ("pod", "model") if rcfg.ep_over_pod else "model"
            if name == "router":
                return spec(fsdp, None)
            if name in ("w_in", "w_gate"):
                return spec(ep, fsdp, None)          # (E, d, f): EP sharding
            if name == "w_out":
                return spec(ep, None, fsdp)
        # ---- rwkv6 time/channel mix + hymba ssd: heads don't divide the
        #      model axis -> replicate over model, FSDP over data ----
        if in_ssm:
            if rcfg.ssm_tp and "time_mix" in names:
                if name in ("wr", "wk", "wv", "wg") and _divisible(
                        leaf.shape[-1], mesh_cfg, "model"):
                    return spec(fsdp, "model")
                if name == "wo" and _divisible(leaf.shape[-2], mesh_cfg,
                                               "model"):
                    return spec("model", fsdp)
            if "channel_mix" in names:
                if name == "wk" and _divisible(leaf.shape[-1], mesh_cfg,
                                               "model"):
                    return spec(fsdp, "model")     # (d, f) TP on f
                if name == "wv":
                    if _divisible(leaf.shape[-2], mesh_cfg, "model"):
                        return spec("model", None)  # (f, d) contraction TP
                    return spec(None, fsdp)
                return spec(fsdp, None)
            if name == "wo":
                return spec(None, fsdp)
            if name == "wb":
                return spec(None, None)
            return spec(fsdp, None)  # wr/wk/wv/wg/wx/wz/wB/wC/wdt/wa
        # ---- attention ----
        if name in ("wq", "wk", "wv"):
            return spec(fsdp, "model")
        if name == "wo":
            return spec("model", fsdp)
        # ---- dense mlp ----
        if name in ("w_in", "w_gate"):
            ok = _divisible(leaf.shape[-1], mesh_cfg, "model")
            return spec(fsdp, "model" if ok else None)
        if name == "w_out":
            ok = _divisible(leaf.shape[-2], mesh_cfg, "model")
            return spec("model" if ok else None, fsdp)
        return P(*((None,) * nd))

    def guarded(names, leaf):
        # universal divisibility guard: drop axes a dim can't divide
        return _fit_spec(rule(names, leaf), leaf.shape, mesh_cfg)

    return _map_with_path(guarded, params_shape)


def _fit_spec(spec: P, shape, mesh_cfg: MeshConfig) -> P:
    """Drop sharding on dims the shape can't divide evenly."""
    sizes = axis_sizes(mesh_cfg)
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        total = 1
        for a in axes:
            total *= sizes.get(a, 1)
        out.append(entry if shape[i] % total == 0 else None)
    return P(*out)


def opt_state_shardings(opt_shape, params_pspecs, mesh_cfg: MeshConfig):
    """Specs of an :class:`~repro_torch.optim.adamw.AdamWState` whose m/v
    may hold ``Q8(q, scale)`` nodes: q inherits the param's spec; scale
    (rank-preserving, last dim /16) the same spec with the divisibility
    fallback. The reference returns ``NamedSharding``s of its mesh; the
    port's specs are mesh-free, so this takes the mesh's config."""
    from repro_torch.optim.adamw import Q8, AdamWState

    def rule(shape_leaf, spec):
        nd = len(shape_leaf.shape)
        if len(spec) != nd:
            spec = P(*(tuple(spec) + (None,) * nd)[:nd])
        return _fit_spec(spec, shape_leaf.shape, mesh_cfg)

    def moments(tree, specs):
        if isinstance(tree, dict):
            return {k: moments(v, specs[k]) for k, v in tree.items()}
        if isinstance(tree, Q8):
            return Q8(q=rule(tree.q, specs), scale=rule(tree.scale, specs))
        return rule(tree, specs)

    master = (moments(opt_shape.master, params_pspecs)
              if opt_shape.master else {})
    return AdamWState(step=P(), master=master,
                      m=moments(opt_shape.m, params_pspecs),
                      v=moments(opt_shape.v, params_pspecs))


def cache_pspecs(caches_shape, cfg: ModelConfig, rcfg: RunConfig,
                 global_batch: int):
    """Decode-cache specs: batch over data axes; full-attention KV caches
    and cross caches shard their sequence dim over ``model`` (paired with
    the lse-combining partitioned decode attention)."""
    mesh_cfg = rcfg.mesh
    bspec = batch_spec(mesh_cfg, global_batch)

    def rule(names, leaf):
        name = names[-1]
        if name in ("k", "v", "ck", "cv"):
            seq = leaf.shape[2]
            seq_shard = ("model" if cfg.attention_kind != "sliding"
                         and rcfg.decode_attention == "partitioned"
                         and _divisible(seq, mesh_cfg, "model") else None)
            return P(None, bspec, seq_shard, None, None)
        # states: (L, B, H, *, *)
        return P(None, bspec, *((None,) * (len(leaf.shape) - 2)))

    return _map_with_path(rule, caches_shape)


def leaf_specs(tree, specs) -> list:
    """[(leaf, spec)] of ``tree`` in its own order, each leaf paired with
    the spec at its path (the two trees' dicts may list keys in other
    orders: JAX's trees sort them)."""
    if isinstance(tree, dict):
        return [pair for k, v in tree.items()
                for pair in leaf_specs(v, specs[k])]
    return [(tree, specs)]


# ----------------------------------------------------------- local shards
def _entry_shards(mesh, entry) -> Tuple[int, int]:
    """(number of shards, this rank's shard) of one spec entry: for a
    tuple of axes the first is the major one, as JAX lays them out."""
    if entry is None:
        return 1, 0
    n, idx = 1, 0
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        s = mesh.size(mesh.mesh_dim_names.index(a))
        n, idx = n * s, idx * s + mesh.get_local_rank(a)
    return n, idx


def local_shard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``, as a new
    contiguous tensor (the full one can be freed)."""
    out = x
    for dim, entry in enumerate(spec):
        n, idx = _entry_shards(mesh, entry)
        if n > 1:
            size = x.shape[dim] // n
            out = out.narrow(dim, idx * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def shard_tree(tree, specs, mesh):
    """Cut every full tensor of ``tree`` (nested dicts; ``Q8`` nodes
    included) to this rank's shard under the matching spec of ``specs``."""
    from repro_torch.optim.adamw import Q8

    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, Q8):
        return Q8(q=local_shard(tree.q, specs.q, mesh),
                  scale=local_shard(tree.scale, specs.scale, mesh))
    return local_shard(tree, specs, mesh)


def gather_tree(tree, specs, mesh):
    """The full tensors back from every rank's shards (each rank gets
    them all): the inverse of :func:`shard_tree`, for tests and
    checkpoints."""
    import torch.distributed as dist

    if isinstance(tree, dict):
        return {k: gather_tree(v, specs[k], mesh) for k, v in tree.items()}
    x = tree
    for dim, entry in enumerate(specs):
        if entry is None:
            continue
        # gather the minor axis first, so the major axis ends outermost
        for a in reversed(entry if isinstance(entry, tuple) else (entry,)):
            group = mesh.get_group(a)
            n = dist.get_world_size(group)
            if n == 1:
                continue
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts, dim=dim)
    return x
