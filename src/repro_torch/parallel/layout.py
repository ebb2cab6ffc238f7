"""Where a layer's sharded weights are put back together before use: the
part of JAX's SPMD partitioning the port does by hand.

Given a rank's local shards and their specs
(:func:`repro_torch.parallel.sharding.param_pspecs`):

* every leaf sharded over ``data`` (ZeRO-3, ``exec_mode="streaming"``)
  is all-gathered over ``data`` where its layer runs
  (:func:`~repro_torch.parallel.collectives.gather_data`: its gradient
  reduce-scatters back);
* a leaf sharded over ``model`` stays a shard where the layer computes
  tensor-parallel on it: attention whose heads split whole over the axis
  (each rank then holds ``Hq/m`` query and ``Hkv/m`` key/value heads), a
  dense MLP, and the experts under expert parallelism. Elsewhere, where
  every model rank repeats the computation (rwkv6's and hymba's SSM
  projections, attention whose heads do not split whole, the tied
  embedding), it is all-gathered over ``model``
  (:func:`~repro_torch.parallel.collectives.gather_model`). Where
  ``_fit_spec`` dropped a sharding, the leaf is whole already.
"""
from __future__ import annotations

from repro_torch.parallel.collectives import (axis_size, gather_data,
                                              gather_model)
from repro_torch.parallel.sharding import P

SSM_PARTS = ("time_mix", "channel_mix", "ssm")
ATTN_PARTS = ("attn", "cross_attn")


def whole_heads(cfg, mesh) -> bool:
    """Attention splits over ``model`` into whole query and key/value
    heads."""
    m = axis_size(mesh, "model")
    return cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0


def _entry_axes(entry):
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def gather_leaf(x, spec: P, mesh, *, over_model: bool):
    """``x`` gathered over ``data`` on the dims its spec shards over it,
    and over ``model`` too where ``over_model``."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if "data" in axes:
            x = gather_data(x, mesh, "data", dim)
        if over_model and "model" in axes:
            x = gather_model(x, mesh, "model", dim)
    return x


def local_layer(p, specs, cfg, mesh):
    """One layer's parameter tree as the layer computes on it (see the
    module docstring). ``specs``: the layer's specs, without the stacked
    leading axis."""
    heads = whole_heads(cfg, mesh)

    def walk(tree, spec, path):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k], path + (k,)) for k, v in tree.items()}
        replicated = (any(n in SSM_PARTS for n in path)
                      or (not heads and any(n in ATTN_PARTS for n in path)))
        return gather_leaf(tree, spec, mesh, over_model=replicated)

    return walk(p, specs, ())


def layer_specs(stacked_specs):
    """Specs of one layer of a stack: the stacked specs without their
    leading (layer) entry."""
    if isinstance(stacked_specs, dict):
        return {k: layer_specs(v) for k, v in stacked_specs.items()}
    return P(*stacked_specs[1:])


def full_tree(tree, specs, mesh):
    """Every leaf of ``tree`` gathered whole (over ``data`` and
    ``model``): the embedding tables, which the port gathers at use."""
    if isinstance(tree, dict):
        return {k: full_tree(v, specs[k], mesh) for k, v in tree.items()}
    return gather_leaf(tree, specs, mesh, over_model=True)
