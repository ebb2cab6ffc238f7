"""Paper Fig. 8: load imbalance (LI, Eq. 3/4) vs layer count and hidden
size under O1/O3 partitioning, with the card's constants, and the MoE
expert-load LI measured on a routed forward. The port of
``benchmarks/bench_load_balance.py``, under the same record names and
derived keys. ``chip`` defaults to the H100; ``load_balance/moe`` runs on
the ``device`` knob's device (``cuda`` unless the caller asks for
``cpu``, as ``--device cpu`` does)."""
from __future__ import annotations

import dataclasses

from repro_torch.bench import (BENCH_MESH, BENCH_SHAPE, BenchRecord,
                               Workload, scenario, timeit_us)
from repro_torch.bench.suites.allocation import hidden_sweep_config
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import metrics, sections
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


MOE_BATCH, MOE_SEQ = 8, 64


def moe_expert_load(cfg, params, x):
    """The per-expert load (E,) of one routed MoE forward of ``x``."""
    from repro_torch.models import moe as moe_mod
    return moe_mod.moe_ffn(params, x, cfg)[1]["expert_load"]


@scenario(
    "load_balance/moe", tags=("tier1", "measured", "fig8", "moe"),
    paper_ref="Fig. 8 (MoE extension)",
    workloads=[Workload(label="experts8", arch="arctic-480b",
                        knobs={"experts": 8})])
def load_balance_moe(wl: Workload):
    """Expert-load LI measured on a real routed forward of a reduced
    arctic block: MOE_BATCH x MOE_SEQ tokens of N(0, 0.1^2), f32, the
    block's parameters from a seeded generator."""
    import torch

    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import resolve_device

    device = resolve_device(wl.knobs.get("device", "cuda"))
    cfg = reduced(ARCHS[wl.arch], experts=wl.knobs["experts"])
    gen = torch.Generator(device=device).manual_seed(0)
    params = moe_mod.moe_init(gen, cfg, torch.float32)
    x = torch.randn((MOE_BATCH, MOE_SEQ, cfg.d_model), generator=gen,
                    device=device) * 0.1
    with torch.no_grad():
        us = timeit_us(moe_expert_load, cfg, params, x)
        load = moe_expert_load(cfg, params, x).cpu().numpy()
    li = metrics.expert_load_imbalance(load)
    yield BenchRecord(name="load_balance/moe_experts/measured",
                      us_per_call=us, derived={"LI": round(float(li), 4)})
