"""Nested-dict parameter trees: the port keeps the JAX package's
parameter layout (plain nested dicts with a leading stacked-layer axis),
so it needs the two tree operations ``jax.tree`` gave the reference."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over nested dicts of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def layer_at(stacked, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return tree_map(lambda a: a[i], stacked)
