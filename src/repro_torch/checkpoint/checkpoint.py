"""Atomic, restart-safe checkpoints: the PyTorch counterpart of
``repro/checkpoint/checkpoint.py``.

Layout, as the reference's: <dir>/step_<N>/
    meta.json               {step, n_leaves, treedef, manifest}
    leaf_<i>.npy            one array per leaf (np.save)
    _COMMITTED              written last -> a partial save is never visible

A save is written into ``.tmp_step_<N>`` and published by ``os.replace``;
``restore_latest`` skips uncommitted and corrupt steps. Leaves are
numbered as the reference numbers them: dict keys in sorted order,
``AdamWState`` as (step, master, m, v), ``Q8`` as (q, scale).

Deliberate differences from the reference:

* the metadata is JSON (``meta.json``), not msgpack;
* a bf16 leaf is saved as its ``uint16`` bits, with ``"dtype":
  "bfloat16"`` in its manifest entry (numpy has no bf16 of its own);
* ``AdamWState.step``, a Python int in the port, is a 0-d int64 leaf;
* :func:`restore` copies INTO the target tree's tensors (``copy_``, on
  their device) and sets the target ``AdamWState``'s step, then returns
  the same tree: at full width a second copy of the params, master and
  moments does not fit on the card. Every leaf is checked against the
  target (shape, saved dtype, a readable file) before the first copy, so
  a corrupt step, or one saved in another dtype (an f32 run's into a bf16
  run's state), leaves the target as it was.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import Q8, AdamWState

BF16 = "bfloat16"


def _structure(tree):
    """A JSON description of the tree's containers, stored with a save
    and compared with the target's on restore."""
    if isinstance(tree, dict):
        return {"dict": {k: _structure(tree[k]) for k in sorted(tree)}}
    if isinstance(tree, AdamWState):
        return {"AdamWState": [_structure(x) for x in (
            tree.master, tree.m, tree.v)]}
    if isinstance(tree, Q8):
        return "Q8"
    return "leaf"


def _leaves(tree) -> list:
    """The leaves in the reference's order; an ``AdamWState``'s step as an
    int."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, AdamWState):
        return [tree.step, *_leaves(tree.master), *_leaves(tree.m),
                *_leaves(tree.v)]
    if isinstance(tree, Q8):
        return [tree.q, tree.scale]
    return [tree]


def _states(tree) -> list:
    """Every ``AdamWState`` in the tree, in leaf order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _states(tree[k])]
    return [tree] if isinstance(tree, AdamWState) else []


def _dtype_name(leaf) -> str:
    """A leaf's dtype as the manifest records it (an int step: int64)."""
    if isinstance(leaf, int):
        return "int64"
    return str(leaf.dtype).removeprefix("torch.")


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf that later in-place updates cannot reach:
    taken now, synchronously (``.cpu()`` of a CPU tensor would share its
    storage, so a CPU tensor is cloned)."""
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int64)
    t = leaf.detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save(ckpt_dir: str | os.PathLike, step: int, tree,
         *, blocking: bool = True) -> threading.Thread | None:
    """Save a tree of tensors (nested dicts, ``AdamWState`` and ``Q8``
    leaves). Every host copy is taken before this returns, also with
    ``blocking=False``, where a thread then writes the files and is
    returned."""
    leaves = _leaves(tree)
    host = [_to_host(x) for x in leaves]
    dtypes = [_dtype_name(x) for x in leaves]
    structure = _structure(tree)

    def _write():
        base = Path(ckpt_dir)
        tmp = base / f".tmp_step_{step}"
        final = base / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = []
        for i, (arr, dt) in enumerate(zip(host, dtypes)):
            np.save(tmp / f"leaf_{i}.npy", arr)
            manifest.append({"i": i, "shape": list(arr.shape), "dtype": dt})
        meta = {"step": step, "n_leaves": len(host), "treedef": structure,
                "manifest": manifest}
        (tmp / "meta.json").write_text(json.dumps(meta))
        (tmp / "_COMMITTED").write_bytes(b"ok")
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def available_steps(ckpt_dir: str | os.PathLike) -> list[int]:
    base = Path(ckpt_dir)
    if not base.exists():
        return []
    steps = []
    for d in base.iterdir():
        if d.name.startswith("step_") and (d / "_COMMITTED").exists():
            try:
                steps.append(int(d.name.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


def _load(path: Path, entry: dict) -> torch.Tensor:
    """One saved leaf as a CPU tensor of its saved dtype."""
    arr = np.load(path)
    if entry["dtype"] == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str | os.PathLike, step: int, target_tree):
    """Copy step ``step``'s leaves into ``target_tree`` (see the module's
    notes) and return it. Raises, with the target untouched, when the
    step is not committed or does not match the target's structure,
    shapes and dtypes."""
    base = Path(ckpt_dir) / f"step_{step}"
    if not (base / "_COMMITTED").exists():
        raise FileNotFoundError(f"no committed checkpoint at {base}")
    meta = json.loads((base / "meta.json").read_text())
    if meta["treedef"] != _structure(target_tree):
        raise ValueError(f"{base}: the saved tree differs from the target's")
    leaves = _leaves(target_tree)
    manifest = meta["manifest"]
    if len(manifest) != len(leaves):
        raise ValueError(f"{base}: {len(manifest)} leaves saved, the "
                         f"target has {len(leaves)}")
    for entry, tgt in zip(manifest, leaves):
        # every file readable at its recorded shape, in the target's
        # dtype, before the first copy
        path = base / f"leaf_{entry['i']}.npy"
        if entry["dtype"] != _dtype_name(tgt):
            raise ValueError(f"{path}: saved as {entry['dtype']}, target "
                             f"{_dtype_name(tgt)}")
        arr = np.load(path, mmap_mode="r")
        shape = tuple(tgt.shape) if torch.is_tensor(tgt) else ()
        if tuple(arr.shape) != shape or list(arr.shape) != entry["shape"]:
            raise ValueError(f"{path}: shape {arr.shape}, target {shape}")
        del arr
    states = iter(_states(target_tree))
    for entry, tgt in zip(manifest, leaves):
        src = _load(base / f"leaf_{entry['i']}.npy", entry)
        if torch.is_tensor(tgt):
            with torch.no_grad():
                tgt.copy_(src)
        else:
            next(states).step = int(src)
    return target_tree


def restore_latest(ckpt_dir, target_tree) -> Tuple[Optional[int], Any]:
    """(step, tree) from the newest committed checkpoint that restores,
    else (None, target). Corrupt newest checkpoints are skipped."""
    for step in reversed(available_steps(ckpt_dir)):
        try:
            return step, restore(ckpt_dir, step, target_tree)
        except Exception:
            continue
    return None, target_tree
