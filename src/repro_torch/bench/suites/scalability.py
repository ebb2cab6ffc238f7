"""Paper Table III / Fig. 11: inter-chip scalability, measured on ranks
of a process group with the reduced granite of the reference (4 layers,
d_model 256, d_ff 1024, vocab 2048; B16 S128, f32):

* DP replicas (WSE-style data parallelism, Fig. 11a): (dp, 1), dp 1-8;
* TP width sweep (RDU-style tensor parallelism, Fig. 11b): (8/tp, tp);
* resident vs streaming (ZeRO-3) weights on (4, 2): the paper's
  whole-graph vs weight-streaming comparison;
* PP layer-allocation sweep (IPU-style, Fig. 11c): 4 stages, layouts
  (2,2,2,2), (1,2,2,3), (1,1,1,5) -- the most-loaded stage governs.

The port of ``benchmarks/bench_scalability.py``, under the same record
names and derived keys. Each point starts its ranks afresh
(:func:`repro_torch.launch.mesh.run_with_ranks`): gloo ranks on the CPU
(``--device cpu``, the reference's sweeps on one host's cores), NCCL
ranks on the card, one card a rank. On the card a point runs only where
the machine has its cards; every other point's record names it as not
run for want of cards, with no time. The ``points`` knob (record names
without the ``scalability/`` prefix) runs a subset.
"""
from __future__ import annotations

from repro_torch.bench import BenchRecord, Workload, scenario

B, S = 16, 128
TOKENS = B * S
PP_LAYOUTS = ((2, 2, 2, 2), (1, 2, 2, 3), (1, 1, 1, 5))
PP = dict(L=8, D=256, M=8, MB=2, SS=64)


def _config():
    from repro_torch.configs import ARCHS, reduced
    return reduced(ARCHS["granite-3-8b"], layers=4, d_model=256, d_ff=1024,
                   vocab=2048)


def _measure(fn, args, iters: int = 4) -> float:
    """Seconds a call: one warm call, then ``iters`` back to back, the
    device synchronised after each group (the reference's timer)."""
    import time

    from repro_torch.core.scalability import _sync

    fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


def _rank_device(device: str):
    """This rank's device: its card (set when its group started), or the
    CPU."""
    import torch

    if torch.device(device).type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def train_step_time(rank: int, n: int, mesh_shape, exec_mode: str,
                    device: str) -> float:
    """One rank of a (data, model) point: the sharded train step's time."""
    import torch

    from repro_torch.configs import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import shard_tree
    from repro_torch.runtime.steps import build_train_step

    cfg = _config()
    mesh_cfg = MeshConfig(shape=tuple(mesh_shape), axes=("data", "model"))
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", "train", S, B),
                     mesh=mesh_cfg, param_dtype="float32",
                     attention_backend="kernel", exec_mode=exec_mode)
    mesh = make_mesh(mesh_cfg, device)
    step, model, opt = build_train_step(rcfg, device=device, mesh=mesh)
    dev = _rank_device(device)
    params = shard_tree(model.init_params(
        torch.Generator(device=dev).manual_seed(rcfg.seed)),
        model.rt.param_specs, mesh)
    opt_state = opt.init(params)
    batch = SyntheticLM(cfg, B, S, seed=rcfg.seed,
                        device=str(dev)).batch_at(0)
    return _measure(step, (params, opt_state, batch))


def pipeline_time(rank: int, n: int, stage_layers, device: str) -> float:
    """One stage of the 4-stage GPipe point: the forward's time."""
    import torch

    from repro_torch.configs import MeshConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_forward, stack_stages

    mesh = make_mesh(MeshConfig(shape=(n,), axes=("model",)), device)
    dev = _rank_device(device)
    g = torch.Generator().manual_seed(0)
    L, D, M, MB, SS = PP["L"], PP["D"], PP["M"], PP["MB"], PP["SS"]
    params = {"w1": torch.randn((L, D, D), generator=g) * 0.05,
              "w2": torch.randn((L, D, D), generator=g) * 0.05}
    x = torch.randn((M, MB, SS, D), generator=g).to(dev)
    staged, mask = stack_stages(params, stage_layers)
    s = mesh.get_local_rank("model")
    local = {k: v[s].to(dev) for k, v in staged.items()}

    def layer_fn(c, p):
        return c + torch.tanh(c @ p["w1"]) @ p["w2"]

    with torch.no_grad():
        return _measure(pipeline_forward,
                        (local, mask[s], x, layer_fn, mesh))


def _points(wl: Workload):
    """(record name, ranks, rank function, its arguments) of a scenario's
    workload."""
    dev = wl.knobs.get("device", "cuda")
    kind = wl.knobs["sweep"]
    if kind == "dp":
        return [(f"dp{dp}", dp, train_step_time, ((dp, 1), "resident", dev))
                for dp in (1, 2, 4, 8)]
    if kind == "tp":
        return [(f"tp{tp}", 8, train_step_time,
                 ((8 // tp, tp), "resident", dev)) for tp in (1, 2, 4, 8)]
    if kind == "streaming":
        return [(mode, 8, train_step_time, ((4, 2), mode, dev))
                for mode in ("resident", "streaming")]
    return [("pp_" + "-".join(map(str, lay)), 4, pipeline_time, (lay, dev))
            for lay in PP_LAYOUTS]


def _run(wl: Workload):
    import torch

    from repro_torch.launch.mesh import run_with_ranks
    from repro_torch.models.model import resolve_device

    device = resolve_device(wl.knobs.get("device", "cuda"))
    have = torch.cuda.device_count() if device.type == "cuda" else None
    want = wl.knobs.get("points")
    times = {}
    for name, n, fn, args in _points(wl):
        if want and name not in want:
            continue
        rec = f"scalability/{name}"
        if have is not None and n > have:
            yield BenchRecord(name=rec, derived={
                "not_run": f"needs {n} cards; this machine has {have}",
                "ranks": n})
            continue
        t = max(run_with_ranks(fn, n, *args, timeout=wl.knobs.get(
            "timeout", 900), device=device.type))
        times[name] = t
        tokens = (PP["M"] * PP["MB"] * PP["SS"] if name.startswith("pp_")
                  else TOKENS)
        derived = {"tok_s": round(tokens / t), "ranks": n,
                   "backend": "nccl" if device.type == "cuda" else "gloo"}
        if name.startswith("pp_"):
            derived["max_stage"] = max(args[0])
        if name == "streaming" and "resident" in times:
            derived["overhead"] = round(t / times["resident"] - 1, 4)
        yield BenchRecord(name=rec, us_per_call=t * 1e6, derived=derived)


@scenario("scalability/dp", tags=("measured", "fig11", "table3"),
          paper_ref="Fig. 11a / Table III",
          workloads=[Workload(label="dp1-8", arch="granite-3-8b",
                              knobs={"sweep": "dp", "devices": 8})])
def scalability_dp(wl: Workload):
    """DP replica scaling 1 -> 8 data shards (WSE-style)."""
    yield from _run(wl)


@scenario("scalability/tp", tags=("measured", "fig11", "table3"),
          paper_ref="Fig. 11b / Table III",
          workloads=[Workload(label="tp1-8", arch="granite-3-8b",
                              knobs={"sweep": "tp", "devices": 8})])
def scalability_tp(wl: Workload):
    """TP width sweep at fixed 8 ranks (RDU-style)."""
    yield from _run(wl)


@scenario("scalability/streaming", tags=("measured", "fig11", "table3"),
          paper_ref="Table III (weight streaming)",
          workloads=[Workload(label="4x2", arch="granite-3-8b",
                              knobs={"sweep": "streaming", "devices": 8})])
def scalability_streaming(wl: Workload):
    """Resident vs streaming (ZeRO-3) weights on a 4x2 mesh."""
    yield from _run(wl)


@scenario("scalability/pp", tags=("measured", "fig11"),
          paper_ref="Fig. 11c",
          workloads=[Workload(label="4stage",
                              knobs={"sweep": "pp", "devices": 4})])
def scalability_pp(wl: Workload):
    """PP layer-allocation sweep: most-loaded stage governs throughput."""
    yield from _run(wl)
