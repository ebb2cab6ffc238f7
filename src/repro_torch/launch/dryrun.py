"""Full-scale dry run on ``meta`` tensors over fake ranks: the counterpart
of ``repro/launch/dryrun.py``.

Where the reference lowers and compiles one step of each (arch x shape)
cell for 256 or 512 placeholder host devices and reads the compiled
module, the port runs the step once, eagerly, on ``meta`` tensors (shapes
and dtypes, no memory, no arithmetic) in a process group of the ``fake``
backend with the production mesh's 256 or 512 ranks, and counts it:

* :func:`repro_torch.core.cost.count_cost_and_peak` counts the step's
  operations and bytes per aten operation, the hand-written kernels' work
  (their wrappers take their plain versions on ``meta``, inside the
  kernel region), the collectives with their process groups' sizes, and
  the bytes the step holds at its peak;
* the record keeps the reference's keys (``memory``, ``roofline``
  against :data:`repro_torch.core.roofline.H100`, ``hlo``), with
  ``count_s`` in place of ``lower_s`` and ``compile_s``.

Every rank of a fake group is rank 0, so the counts are rank 0's: its
shards, its rows of the batch and its collectives (``"counts_of":
"rank 0"`` in the record). The eager peak is the port's own: no XLA
buffer assignment, so the reference's correction of an XLA:CPU artifact
(``cpu_f32_dup_gb``, ``tpu_adjusted_peak_gb``) has no counterpart. Each
rank takes the whole global batch of a training step and computes its
rows of it, as the port's sharded step does, so the batch counts whole
among the arguments.

The cells' run configurations are :mod:`repro_torch.launch.cells`',
chosen by the reference for 16 GB chips; each record says how its peak
sits against the H100's 80 GB. The reference's ``chunked`` attention is
the port's flash kernels (``attention_backend="kernel"``); a prefill of
the ssm and hybrid families runs kernel B6, whose work on ``meta`` counts
every chunk on its rescaled branch (no decays to read).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Records land in ``results/dryrun_torch/<arch>_<shape>_<mesh>.json``. The
``fake`` backend is registered and used here only; nothing else in the
port picks it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, MeshConfig, RunConfig
from repro_torch.core.cost import count_cost_and_peak
from repro_torch.core.profiler import model_flops_for
from repro_torch.core.roofline import H100, roofline
from repro_torch.launch.cells import all_cells, cell_run_config
from repro_torch.models.frontends import prefill_batch_spec, train_batch_spec
from repro_torch.models.model import abstract_params
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as shd

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
META = torch.device("meta")


def fake_world(n_ranks: int) -> None:
    """A process group of ``n_ranks`` ranks on the ``fake`` backend, this
    process rank 0 of it. A fake group of another size is replaced; a
    real one is left alone and refused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is up; the dry run "
                               "needs a fake one of its own")
        if dist.get_world_size() == n_ranks:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)


def fake_mesh(mesh_cfg: MeshConfig):
    """A ``DeviceMesh`` of ``mesh_cfg`` over a fake world of its size."""
    from torch.distributed.device_mesh import init_device_mesh

    fake_world(mesh_cfg.num_devices)
    return init_device_mesh("cpu", tuple(mesh_cfg.shape),
                            mesh_dim_names=tuple(mesh_cfg.axes))


def _meta_batch(spec: dict) -> dict:
    return {k: torch.empty(shape, dtype=dt, device=META)
            for k, (shape, dt) in spec.items()}


def _local_batch(batch: dict, rt) -> dict:
    """This rank's rows of a prefill batch, over the batch axes of the
    model's runtime (the rows a sharded prefill takes)."""
    n = coll.axis_size(rt.mesh, rt.mesh_batch_axes)
    idx = coll.axis_index(rt.mesh, rt.mesh_batch_axes)
    return {k: v.narrow(0, idx * (v.shape[0] // n), v.shape[0] // n)
            .clone() for k, v in batch.items()}


def train_parts(step, opt):
    """One training step, counted part for part in ``train_step``'s order
    (:func:`repro_torch.runtime.steps.build_train_step`): its gradients
    (the accumulation, the data-axis average or reduce-scatter, the loss's
    mean and the sharded norm), the finite-loss check (made, not read:
    ``meta`` holds no value) and the AdamW update. The same operations as
    the step, without the host's reads of the device."""

    def run(params, opt_state, batch):
        gsum, loss, stats, gnorm = step.gradients(params, batch)
        torch.isfinite(loss)
        params, opt_state, m = opt.update(gsum, opt_state, params,
                                          gnorm=gnorm)
        return params, opt_state, {"loss": loss, **stats, **m}

    return run


def input_specs(rcfg: RunConfig, mesh, device=META):
    """The cell's step and this rank's inputs on ``device`` (``meta``
    for the dry run): params, optimizer state and the global batch of a
    training step; params and this rank's rows of a prefill batch; params,
    this rank's caches, tokens and an int position of a decode step.
    Returns (step, args, model)."""
    from repro_torch.runtime.steps import build_decode_step, build_train_step

    arch, shape = rcfg.model, rcfg.shape
    B, S = shape.global_batch, shape.seq_len
    # the reference's chunked flash attention is the port's kernel backend
    rcfg = dataclasses.replace(rcfg, attention_backend="kernel")
    if shape.kind == "train":
        step, model, opt = build_train_step(rcfg, device=device, mesh=mesh)
        params = shd.shard_tree(abstract_params(arch, getattr(
            torch, rcfg.param_dtype)), model.rt.param_specs, mesh)
        opt_state = opt.init(params)
        batch = _meta_batch(train_batch_spec(arch, B, S))
        return train_parts(step, opt), (params, opt_state, batch), model
    # a prefill of the ssm and hybrid families runs B6
    _, model = build_decode_step(rcfg, device=device, mesh=mesh,
                                 ssm_backend="kernel")
    params = shd.shard_tree(abstract_params(arch, getattr(
        torch, rcfg.param_dtype)), model.rt.param_specs, mesh)
    if shape.kind == "prefill":
        batch = _local_batch(_meta_batch(prefill_batch_spec(arch, B, S)),
                             model.rt)

        def prefill_step(params, batch):
            return model.prefill(params, batch, S)

        return prefill_step, (params, batch), model
    caches = model.cache_init(B, S, enc_len=S)
    caches = shd.shard_tree(caches, shd.cache_pspecs(caches, arch, rcfg, B),
                            mesh)
    b_loc = next(iter(caches["layers"].values())).shape[1]
    token = torch.empty((b_loc, 1), dtype=torch.int32, device=device)
    # an int position: the same work as a (B,) tensor of them, and the
    # only form ``meta`` can take (no per-row slot to read)
    return model.decode_step, (params, caches, token, S - 1), model


def warm_constants(cfg, device=META) -> None:
    """Make the model's cached constants (the rotary frequencies) on
    ``device`` before a count: a step on a warm process loads none, so a
    count that did would hold one load more than the step's own work."""
    from repro_torch.models.layers import _rope_freqs_on

    if cfg.num_heads:
        _rope_freqs_on(cfg.resolved_head_dim, float(cfg.rope_theta),
                       torch.device(device))


def count_cell(rcfg: RunConfig, mesh, device=META):
    """(the step's result, CostReport, MemoryReport, seconds) of one step
    of ``rcfg`` on ``mesh``, its inputs built on ``device``."""
    step, args, _ = input_specs(rcfg, mesh, device)
    warm_constants(rcfg.model, device)
    t0 = time.perf_counter()
    out, report, mem = count_cost_and_peak(step, *args)
    return out, report, mem, time.perf_counter() - t0


def record(arch_name: str, shape_name: str, rcfg: RunConfig, multi_pod: bool,
           report, mem, count_s: float) -> dict:
    """The dry run's record of a counted cell, in the reference's keys."""
    mf = model_flops_for(rcfg.model, rcfg.shape)
    rl = roofline(report, chips=rcfg.mesh.num_devices, model_flops=mf,
                  dtype=rcfg.param_dtype, chip=H100)
    memory = mem.to_gb()
    return {
        "arch": arch_name, "shape": shape_name,
        "mesh": "x".join(map(str, rcfg.mesh.shape)),
        "devices": rcfg.mesh.num_devices,
        "exec_mode": rcfg.exec_mode, "microbatches": rcfg.microbatches,
        "multi_pod": multi_pod,
        "device": "meta", "counts_of": "rank 0",
        "count_s": count_s,
        "memory": {**memory, "hbm_gb": H100.hbm_bytes / 1e9,
                   "fits": memory["peak_gb"] <= H100.hbm_bytes / 1e9},
        "roofline": rl.to_dict(),
        "hlo": {
            "flops_per_device": report.flops,
            "dot_flops_per_device": report.dot_flops,
            "bytes_per_device": report.bytes,
            "collective_bytes": report.collective_bytes,
            "collective_ici_bytes": report.collective_ici_bytes,
            "collective_breakdown": report.collective_summary(),
            "n_collectives": len(report.collectives),
            "warnings": [],
        },
        "kernels": report.kernels,
    }


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
             rcfg: RunConfig = None, tag: str = "",
             results_dir: Path = RESULTS_DIR, save: bool = True) -> dict:
    """Count one cell on ``meta`` over a fake world of its mesh and write
    its record (``results_dir/<arch>_<shape>_<mesh><tag>.json``)."""
    rcfg = rcfg or cell_run_config(arch_name, shape_name,
                                   multi_pod=multi_pod)
    mesh = fake_mesh(rcfg.mesh)
    _, report, mem, count_s = count_cell(rcfg, mesh)
    rec = record(arch_name, shape_name, rcfg, multi_pod, report, mem,
                 count_s)
    if save:
        results_dir = Path(results_dir)
        results_dir.mkdir(parents=True, exist_ok=True)
        (results_dir / f"{arch_name}_{shape_name}_{rec['mesh']}{tag}.json"
         ).write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="full-scale dry run on meta tensors over fake ranks")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    failures = []
    for arch_name, shape_name in cells:
        try:
            rec = run_cell(arch_name, shape_name, multi_pod=args.multi_pod)
            rl = rec["roofline"]
            print(f"OK {arch_name:28s} {shape_name:12s} mesh={rec['mesh']:8s} "
                  f"count={rec['count_s']:6.1f}s "
                  f"peak={rec['memory']['peak_gb']:7.2f}GB "
                  f"dominant={rl['dominant']:10s} "
                  f"terms(c/m/n)=({rl['compute_s']:.3e},{rl['memory_s']:.3e},"
                  f"{rl['collective_s']:.3e})s", flush=True)
        except Exception as e:
            traceback.print_exc()
            failures.append((arch_name, shape_name, str(e)[:300]))
            print(f"FAIL {arch_name} {shape_name}: {e}", flush=True)
    print(f"\n{len(cells) - len(failures)}/{len(cells)} cells passed "
          f"({'multi-pod' if args.multi_pod else 'single-pod'})")
    for f in failures:
        print("FAILED:", f)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
