"""Launch-parameter sweeps (``python -m repro_torch.bench --tune``): the
port of ``benchmarks/bench_tune.py``.

Each scenario sweeps one kernel's open launch parameter
(:mod:`repro_torch.bench.tune`) over its shapes, persists the winner to
``results/tuned/cuda.json`` and yields a tuned-against-default record:
``tuned_us``, ``default_us``, ``speedup``, ``signature``,
``n_candidates`` and ``rejected_smem`` (the reference's
``rejected_vmem``). Shapes: the reference's (``ref``) and, on the card,
the serving path's at full width (``path``): K2 at granite's decode (B4
ctx160 ps16 Hq32 Hkv8 D128), B6 at rwkv6-3b's layer (T128 H40 K64 V64
with u), K3 at 128 x 4096.

Tagged ``tune``: left out of every run unless ``--tune`` asks for them.
On ``--device cpu`` a workload is not run and its record says so
(``not_run``), as ``kernels/*`` does: the wrappers run the plain versions
there, which ignore the launch parameter, so no plain time may stand as a
tuned one. The attention tiles are compiled in, so ``tune/attention``
and ``tune/attention_bwd`` have no counterpart.
"""
from __future__ import annotations

from repro_torch.bench import BenchRecord, Workload, scenario

_TAGS = ("tune", "kernel", "kernels", "measured")
SHAPES = ("ref", "path")
# labels keyed to the shape, as the reference's
PAGED_SHAPES = {
    "ref": ("B4_P64_ps16_H4_KV2_D64",
            dict(B=4, P=64, ps=16, Hq=4, Hkv=2, D=64, npag=16)),
    "path": ("B4_ctx160_ps16_H32_KV8_D128",
             dict(B=4, P=41, ps=16, Hq=32, Hkv=8, D=128, npag=10, ctx=160)),
}
WKV_SHAPES = {
    "ref": ("B1_T256_H2_K64", dict(B=1, T=256, H=2, K=64, V=64, u=False)),
    "path": ("B1_T128_H40_K64_V64_u",
             dict(B=1, T=128, H=40, K=64, V=64, u=True)),
}
NORM_SHAPES = {
    "ref": [("r4096_d512", dict(rows=4096, d=512)),
            ("r1024_d256", dict(rows=1024, d=256))],
    "path": [("r128_d4096", dict(rows=128, d=4096))],
}
# back-to-back calls a timing replays (bench.tune.graph_timer)
GRAPH_CALLS = 50


def _workloads(shapes: dict):
    out = []
    for shape in SHAPES:
        entries = shapes[shape]
        for label, spec in (entries if isinstance(entries, list)
                            else [entries]):
            out.append(Workload(label=f"{shape}_{label}",
                                knobs={"shape": shape, **spec}))
    return out


def _device(wl: Workload):
    from repro_torch.models.model import resolve_device
    return resolve_device(wl.knobs.get("device", "cuda"))


def _not_run(name: str, device):
    """The record of a sweep the CPU does not run."""
    if device.type == "cuda":
        return None
    return BenchRecord(name=name, derived={
        "device": device.type,
        "not_run": "the sweeps time the kernels, which run only on the "
                   "card; on the CPU the wrappers run the plain versions, "
                   "which ignore the launch parameter"})


def _record(kind: str, label: str, res) -> BenchRecord:
    """A TuneResult as a BenchRecord (the heuristic's pick is candidate
    0, so tuned <= default)."""
    us = res.us
    return BenchRecord(
        name=f"tune/{kind}/{label}", us_per_call=us,
        p50_us=getattr(us, "p50_us", 0.0), p95_us=getattr(us, "p95_us", 0.0),
        samples_us=list(getattr(us, "samples", ())), knobs=dict(res.config),
        derived={"tuned_us": float(res.us),
                 "default_us": float(res.default_us),
                 "speedup": float(res.speedup),
                 "signature": res.signature,
                 "n_candidates": res.n_candidates,
                 "rejected_smem": res.rejected_smem,
                 "default_timed": res.default_timed,
                 "timings": dict(res.timings)})


@scenario("tune/paged_attention", tags=_TAGS + ("serving",),
          paper_ref="guidance for perf opts",
          workloads=_workloads(PAGED_SHAPES))
def tune_paged_attention(wl: Workload):
    """Sweep K2's split count; persist the winner."""
    import numpy as np
    import torch

    from repro_torch.bench import tune

    name = f"tune/paged_attention/{wl.label}"
    device = _device(wl)
    skip = _not_run(name, device)
    if skip is not None:
        yield skip
        return
    s = wl.knobs
    rng = np.random.default_rng(0)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device)

    q = draw(s["B"], 1, s["Hq"], s["D"])
    kp, vp = (draw(s["P"], s["ps"], s["Hkv"], s["D"]) for _ in range(2))
    if "ctx" in s:     # the engine's table: each row its own pages
        btab = (torch.randperm(s["P"] - 1, generator=torch.Generator()
                               .manual_seed(0)) + 1)[:s["B"] * s["npag"]]
        btab = btab.reshape(s["B"], s["npag"])
        lens = torch.tensor([s["ctx"] - i for i in (0, 1, 5, 15)][:s["B"]])
    else:
        btab = torch.from_numpy(rng.integers(1, s["P"], (s["B"], s["npag"])))
        lens = torch.from_numpy(rng.integers(1, s["npag"] * s["ps"] + 1,
                                             s["B"]))
    btab = btab.to(device=device, dtype=torch.int32).contiguous()
    lens = lens.to(device=device, dtype=torch.int32)
    res = tune.tune_paged_attention(q, kp, vp, btab, lens, iters=5,
                                    warmup=2,
                                    timer=tune.graph_timer(GRAPH_CALLS))
    tune.save([res])
    yield _record("paged_attention", wl.label, res)


@scenario("tune/wkv6", tags=_TAGS + ("ssm",),
          paper_ref="guidance for perf opts",
          workloads=_workloads(WKV_SHAPES))
def tune_wkv6(wl: Workload):
    """Sweep B6's V slice; persist the winner."""
    import numpy as np
    import torch

    from repro_torch.bench import tune

    name = f"tune/wkv6/{wl.label}"
    device = _device(wl)
    skip = _not_run(name, device)
    if skip is not None:
        yield skip
        return
    s = wl.knobs
    rng = np.random.default_rng(0)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device)

    q, k = draw(s["B"], s["T"], s["H"], s["K"]), draw(s["B"], s["T"],
                                                       s["H"], s["K"])
    v = draw(s["B"], s["T"], s["H"], s["V"])
    ld = -torch.exp(draw(s["B"], s["T"], s["H"], s["K"]))
    u = 0.1 * draw(s["H"], s["K"]) if s["u"] else None
    res = tune.tune_wkv6(q, k, v, ld, u, iters=5, warmup=2,
                         timer=tune.graph_timer(GRAPH_CALLS))
    tune.save([res])
    yield _record("wkv6", wl.label, res)


@scenario("tune/rmsnorm", tags=_TAGS, paper_ref="guidance for perf opts",
          workloads=_workloads(NORM_SHAPES))
def tune_rmsnorm(wl: Workload):
    """Sweep K3's threads a row; persist the winner."""
    import numpy as np
    import torch

    from repro_torch.bench import tune

    name = f"tune/rmsnorm/{wl.label}"
    device = _device(wl)
    skip = _not_run(name, device)
    if skip is not None:
        yield skip
        return
    rng = np.random.default_rng(0)
    rows, d = wl.knobs["rows"], wl.knobs["d"]
    x = torch.from_numpy(rng.standard_normal((rows, d), np.float32)).to(
        device)
    sc = torch.ones(d, dtype=torch.float32, device=device)
    res = tune.tune_rmsnorm(x, sc, iters=5, warmup=2,
                            timer=tune.graph_timer(GRAPH_CALLS))
    tune.save([res])
    yield _record("rmsnorm", wl.label, res)
