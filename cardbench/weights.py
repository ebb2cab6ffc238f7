"""The weights, made by the benchmark from the seed on the device: one draw
of normals for every drawn leaf, in the type they are served in, each leaf
a view of it scaled to its width's standard deviation. The tree has the
layout the program takes (the JAX package's: nested dicts, a leading
stacked-layer axis on every layer leaf, ``x @ W`` with W shaped
(d_in, d_out), the vocabulary padded to a multiple of 256); the plain
reference reads the same tree.
"""
from __future__ import annotations

import math

import torch

VOCAB_PAD = 256


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_PAD) * VOCAB_PAD


def layout(c: dict) -> dict:
    """{path: (shape, init)}: init is a standard deviation (a normal
    draw) or "ones" / "zeros"."""
    d, L, hd = c["hidden_size"], c["num_hidden_layers"], c["head_dim"]
    nq, nkv, f = c["num_attention_heads"], c["num_key_value_heads"], \
        c["intermediate_size"]
    pv = padded_vocab(c["vocab_size"])
    out = {("embed", "tok"): ((pv, d), 0.02)}
    if not c["tie_word_embeddings"]:
        out[("embed", "head")] = ((d, pv), 0.02)
    lay = {
        ("norm1", "scale"): ((d,), "ones"),
        ("norm2", "scale"): ((d,), "ones"),
        ("attn", "wq"): ((d, nq * hd), 1 / math.sqrt(d)),
        ("attn", "wk"): ((d, nkv * hd), 1 / math.sqrt(d)),
        ("attn", "wv"): ((d, nkv * hd), 1 / math.sqrt(d)),
        ("attn", "wo"): ((nq * hd, d), 1 / math.sqrt(nq * hd)),
        ("mlp", "w_in"): ((d, f), 1 / math.sqrt(d)),
        ("mlp", "w_gate"): ((d, f), 1 / math.sqrt(d)),
        ("mlp", "w_out"): ((f, d), 1 / math.sqrt(f)),
    }
    for k, (shape, init) in lay.items():
        out[("layers", *k)] = ((L, *shape), init)
    out[("final_norm", "scale")] = ((d,), "ones")
    return out


def make(c: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The weight tree of config ``c`` for ``seed``: the same seed gives
    the same weights."""
    lay = layout(c)
    drawn = {k: v for k, v in lay.items() if not isinstance(v[1], str)}
    total = sum(math.prod(shape) for shape, _ in drawn.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=gen)
    tree, at = {}, 0
    for path, (shape, init) in lay.items():
        if isinstance(init, str):
            leaf = (torch.ones if init == "ones" else torch.zeros)(
                shape, dtype=torch.float32, device=device)
        else:
            n = math.prod(shape)
            leaf = flat[at:at + n].view(shape).mul_(init)
            at += n
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def leaves(tree: dict, prefix=()) -> list:
    """[(path, tensor)] in a fixed order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(leaves(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def per_layer(tree: dict) -> list:
    """[(name, tensor)]: every leaf, a layer stack's leaves split into
    their layers ("layers.attn.wq.3")."""
    out = []
    for path, t in leaves(tree):
        name = ".".join(path)
        if path[0] == "layers":
            out.extend((f"{name}.{i}", t[i]) for i in range(t.shape[0]))
        else:
            out.append((name, t))
    return out


def tree_of(paths: list, tensors: list) -> dict:
    """The nested tree of ``tensors`` at ``paths`` (as :func:`leaves`)."""
    tree = {}
    for path, t in zip(paths, tensors):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree


def norms(tree: dict, scale: float = 1.0) -> dict:
    """{leaf name: norm} of every leaf of :func:`per_layer`, read from the
    device in one transfer."""
    named = per_layer(tree)
    vals = torch.stack([t.detach().float().norm() for _, t in named])
    return {n: v * scale for (n, _), v in zip(named, vals.tolist())}
