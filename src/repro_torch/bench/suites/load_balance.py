"""Paper Fig. 8: load imbalance (LI, Eq. 3/4) vs layer count and hidden
size under O1/O3 partitioning, with the card's constants. The port of
``benchmarks/bench_load_balance.py``'s structural scenarios, under the
same record names and derived keys (its MoE expert-load scenario waits
for the port's moe family). ``chip`` defaults to the H100."""
from __future__ import annotations

import dataclasses

from repro_torch.bench import (BENCH_MESH, BENCH_SHAPE, BenchRecord,
                               Workload, scenario)
from repro_torch.bench.suites.allocation import hidden_sweep_config
from repro_torch.configs import ARCHS
from repro_torch.core import sections
from repro_torch.core.roofline import H100

PARTITION_MODES = ("O1", "O3")


@scenario(
    "load_balance/layers", tags=("tier1", "structural", "fig8"),
    paper_ref="Fig. 8a",
    workloads=[Workload(label=f"layers{L}", arch="granite-3-8b",
                        shape=BENCH_SHAPE, mesh=BENCH_MESH,
                        knobs={"num_layers": L})
               for L in (6, 12, 24, 48)])
def load_balance_layers(wl: Workload, chip=H100):
    """LI vs layer count under O1/O3 partitioning."""
    cfg = dataclasses.replace(ARCHS[wl.arch],
                              num_layers=wl.knobs["num_layers"])
    for m in PARTITION_MODES:
        rep = sections.analyze(cfg, wl.shape, wl.mesh, m, chip)
        yield BenchRecord(name=f"load_balance/{wl.label}/{m}",
                          knobs={"mode": m},
                          derived={"LI": round(rep.load_imbalance, 4)})


@scenario(
    "load_balance/hidden", tags=("tier1", "structural", "fig8"),
    paper_ref="Fig. 8b",
    workloads=[Workload(label=f"hs{hs}", arch="granite-3-8b",
                        shape=BENCH_SHAPE, mesh=BENCH_MESH,
                        knobs={"d_model": hs})
               for hs in (512, 1024, 2048, 4096)])
def load_balance_hidden(wl: Workload, chip=H100):
    """LI vs hidden size at fixed depth under O1/O3 partitioning."""
    cfg = hidden_sweep_config(wl.arch, wl.knobs["d_model"])
    for m in PARTITION_MODES:
        rep = sections.analyze(cfg, wl.shape, wl.mesh, m, chip)
        yield BenchRecord(name=f"load_balance/{wl.label}/{m}",
                          knobs={"mode": m},
                          derived={"LI": round(rep.load_imbalance, 4)})
