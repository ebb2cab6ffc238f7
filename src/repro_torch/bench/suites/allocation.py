"""Paper Table I / Fig. 6-7: resource-allocation ratio vs layer count and
hidden size, per compile mode (O0/O1/O3), from the Tier-1 section engine
with the card's constants. The port of ``benchmarks/bench_allocation.py``:
the same record names and derived keys. ``chip`` defaults to the H100."""
from __future__ import annotations

import dataclasses

from repro_torch.bench import (BENCH_MESH, BENCH_SHAPE, BenchRecord,
                               Workload, scenario, timeit_us)
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.core import sections
from repro_torch.core.roofline import H100

COMPILE_MODES = ("O0", "O1", "O3")


def hidden_sweep_config(arch: str, hs: int):
    """The arch at hidden size ``hs`` and 12 layers, heads of 128, a
    quarter as many kv heads (Fig. 7b and 8b)."""
    nq = max(4, hs // 128)
    return dataclasses.replace(ARCHS[arch], d_model=hs, d_ff=4 * hs,
                               num_heads=nq, num_kv_heads=max(1, nq // 4),
                               head_dim=128, num_layers=12)


@scenario(
    "allocation/layers", tags=("tier1", "structural", "table1", "fig6"),
    paper_ref="Table I / Fig. 6",
    workloads=[Workload(label=f"layers{L}", arch="granite-3-8b",
                        shape=BENCH_SHAPE, mesh=BENCH_MESH,
                        knobs={"num_layers": L})
               for L in (6, 12, 24, 48)])
def allocation_layers(wl: Workload, chip=H100):
    """Allocation ratio (Eq. 2) vs layer count, all three compile modes."""
    cfg = dataclasses.replace(ARCHS[wl.arch],
                              num_layers=wl.knobs["num_layers"])
    for m in COMPILE_MODES:
        rep = sections.analyze(cfg, wl.shape, wl.mesh, m, chip)  # warms up
        us = timeit_us(sections.analyze, cfg, wl.shape, wl.mesh, m, chip,
                       iters=5, warmup=0)
        yield BenchRecord(
            name=f"allocation/{wl.label}/{m}",
            us_per_call=us,
            knobs={"mode": m},
            derived={"alloc": round(rep.allocation, 4),
                     "n_sections": rep.n_sections})


@scenario(
    "allocation/hidden", tags=("tier1", "structural", "fig7"),
    paper_ref="Fig. 7b",
    workloads=[Workload(label=f"hs{hs}", arch="granite-3-8b",
                        shape=BENCH_SHAPE, mesh=BENCH_MESH,
                        knobs={"d_model": hs})
               for hs in (512, 1024, 2048, 4096)])
def allocation_hidden(wl: Workload, chip=H100):
    """Allocation ratio vs hidden size at fixed depth, O3 partitioning."""
    cfg = hidden_sweep_config(wl.arch, wl.knobs["d_model"])
    rep = sections.analyze(cfg, wl.shape, wl.mesh, "O3", chip)  # warms up
    us = timeit_us(sections.analyze, cfg, wl.shape, wl.mesh, "O3", chip,
                   iters=5, warmup=0)
    yield BenchRecord(name=f"allocation/{wl.label}/O3", us_per_call=us,
                      knobs={"mode": "O3"},
                      derived={"alloc": round(rep.allocation, 4)})


@scenario(
    "allocation/archs", tags=("tier1", "structural", "table1"),
    paper_ref="Table I",
    workloads=[Workload(label=name, arch=name, shape=SHAPES["train_4k"],
                        mesh=BENCH_MESH)
               for name in sorted(ARCHS)])
def allocation_archs(wl: Workload, chip=H100):
    """Structural allocation at train_4k for every assigned architecture."""
    rep = sections.analyze(ARCHS[wl.arch], wl.shape, wl.mesh, "O3", chip)
    yield BenchRecord(name=f"allocation/{wl.arch}/O3",
                      knobs={"mode": "O3"},
                      derived={"alloc": round(rep.allocation, 4)})
