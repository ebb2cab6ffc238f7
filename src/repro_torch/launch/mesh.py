"""Mesh construction over ``torch.distributed``: the counterpart of
``repro/launch/mesh.py``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` whose
dimension names are :class:`~repro_torch.configs.base.MeshConfig`'s
``axes``, one rank a device. On the card it runs over NCCL; gloo is used
only where the caller asks for the CPU (the tests, ``--device cpu``).
Nothing here falls back from one to the other.

The reference's ``parallel/compat.py`` (a seam between jax versions) has
no counterpart: the port calls ``torch.distributed`` directly.

:func:`run_with_ranks` is the counterpart of the reference tests'
``run_with_devices``: where JAX simulates N devices in one process, the
port starts N processes, one rank each.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.configs.base import MeshConfig


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    """The paper's production meshes: 16x16 = 256 chips a pod; two pods."""
    if multi_pod:
        return MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model"))
    return MeshConfig(shape=(16, 16), axes=("data", "model"))


def backend_for(device: str) -> str:
    """NCCL on the card, gloo only where the caller asks for the CPU. A
    card without NCCL raises: the port does not fall back to gloo."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL here; the "
                               "port's meshes on the card need it")
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"unsupported device {device!r}")


def init_world(device: str = "cuda", *, store_dir: Optional[str] = None,
               rank: int = 0, world_size: int = 1) -> None:
    """Start the default process group unless one is up. With
    ``store_dir``, the ranks meet through a ``FileStore`` in it (no port);
    otherwise through the environment ``torchrun`` sets (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). On the card each
    rank takes the device of its local rank."""
    if dist.is_initialized():
        return
    backend = backend_for(device)
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
    if store_dir is not None:
        store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)
    else:
        dist.init_process_group(backend)


def make_mesh(mesh_cfg: MeshConfig, device: str = "cuda") -> DeviceMesh:
    """A DeviceMesh of ``mesh_cfg``'s shape over the ranks of the world,
    dimensions named by its axes. Starts the process group from the
    environment (``torchrun``) if none is up; the world must hold exactly
    ``mesh_cfg.num_devices`` ranks."""
    init_world(device)
    if dist.get_world_size() != mesh_cfg.num_devices:
        raise ValueError(f"mesh {mesh_cfg.shape} needs "
                         f"{mesh_cfg.num_devices} ranks; the world has "
                         f"{dist.get_world_size()}")
    kind = torch.device(device).type
    if kind == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError("a mesh on the card runs over NCCL; the process "
                           f"group uses {dist.get_backend()}")
    return init_device_mesh(kind, tuple(mesh_cfg.shape),
                            mesh_dim_names=tuple(mesh_cfg.axes))


# ------------------------------------------------------------ test ranks
def _rank_main(rank: int, n: int, store_dir: str, device: str,
               queue) -> None:
    torch.set_num_threads(1)
    try:
        with open(os.path.join(store_dir, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        init_world(device, store_dir=store_dir, rank=rank, world_size=n)
        out = fn(rank, n, *args)
        queue.put((rank, "ok", out))
    except Exception:                    # reported to the caller, who raises
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_with_ranks(fn: Callable[..., Any], n: int, *args,
                   timeout: float = 300.0, device: str = "cpu") -> List[Any]:
    """Run ``fn(rank, n, *args)`` on ``n`` fresh processes, one rank each,
    in a process group of its own (gloo on ``cpu``, NCCL on ``cuda``,
    rank r on card r), and return their results in rank order. The ranks
    meet through a ``FileStore`` in a new temporary directory, so
    concurrent callers never collide on a port. Each rank runs on one
    thread. ``fn`` and ``args`` must pickle (a module-level function). A
    rank that raises, dies or outlives ``timeout`` seconds fails the call,
    and every rank still running is killed."""
    import multiprocessing as mp
    import queue as queue_mod
    import time

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ranks-") as store_dir:
        # the call goes by file: a start's arguments pass through a pipe
        # the new process reads only once it has imported its modules, so
        # large ones would start the ranks one after another
        with open(os.path.join(store_dir, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, store_dir, device, q),
                             daemon=True) for r in range(n)]
        for p in procs:
            p.start()
        results: dict = {}
        deadline = time.monotonic() + timeout
        try:
            while len(results) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(n)) - set(results))} of "
                        f"{n} did not finish within {timeout} s")
                try:
                    rank, status, out = q.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and not p.is_alive()
                            and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank(s) {dead} of {n} died (exit codes "
                            f"{[procs[r].exitcode for r in dead]})")
                    continue
                if status == "error":
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{out}")
                results[rank] = out
        finally:
            # after a failure the others may wait on it forever: kill them
            grace = 5.0 if len(results) == n else 0.0
            for p in procs:
                p.join(timeout=grace)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(n)]
