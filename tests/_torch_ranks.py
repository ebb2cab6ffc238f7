"""Rank functions of the port's multi-rank tests: run on fresh
processes by ``run_with_ranks``, so they live apart from the test files,
whose imports (JAX among them) every rank would otherwise repeat."""
import numpy as np
import torch

GRANITE = dict(d_model=128, vocab=512)


def _device(kind: str):
    """This rank's device: its card (set when its group started), or the
    CPU."""
    if kind == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def dp_tp_rank(rank, n, shape, params_np, batch_np, kind="cpu"):
    """One rank: the unsharded port step, then the sharded step in both
    modes from the same params (``params_np``: the JAX package's, as
    numpy; None: the port's init from seed 0); returns rank 0's losses,
    grad norms and the gathered params after each step. On ``kind``
    "cuda" the attention runs through the kernels, on this rank's
    card."""
    from repro_torch._tree import tree_leaves
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import (ARCHS, MeshConfig, RunConfig,
                                     ShapeConfig, reduced)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime.steps import build_train_step

    dev = _device(kind)
    cfg = reduced(ARCHS["granite-3-8b"], **GRANITE)
    mesh_cfg = MeshConfig(shape=shape, axes=("data", "model"))
    batch = {k: torch.from_numpy(np.array(v)).to(dev)
             for k, v in batch_np.items()}
    mesh = make_mesh(mesh_cfg, kind)
    out = {}
    for mode in ("unsharded", "resident", "streaming"):
        rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 32, 4),
                         mesh=mesh_cfg, param_dtype="float32",
                         attention_backend="kernel" if kind == "cuda"
                         else "dense", microbatches=2,
                         exec_mode="streaming" if mode == "streaming"
                         else "resident")
        sharded = mode != "unsharded"
        step, model, opt = build_train_step(
            rcfg, device=dev, mesh=mesh if sharded else None)
        if params_np is None:
            params = model.init_params(torch.Generator(
                device=dev).manual_seed(0))
        else:
            params = params_from_jax(params_np, dev)
        if sharded:
            params = shd.shard_tree(params, model.rt.param_specs, mesh)
        state = opt.init(params)
        _, _, m = step(params, state, batch)
        if sharded:
            params = shd.gather_tree(params, model.rt.param_specs, mesh)
        out[mode] = (float(m["loss"]), float(m["grad_norm"]),
                     [t.cpu().numpy() for t in tree_leaves(params)])
    return out if rank == 0 else None


def decode_rank(rank, n, q, k, v, lens):
    from repro_torch.configs import MeshConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.collectives import partitioned_decode_attention
    from repro_torch.parallel.sharding import P, local_shard

    mesh = make_mesh(MeshConfig(shape=(2, 4), axes=("data", "model")), "cpu")
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    ql = local_shard(q, P("data"), mesh)
    kl, vl = (local_shard(t, P("data", "model"), mesh) for t in (k, v))
    outs = []
    for n_len in lens:
        if isinstance(n_len, tuple):
            n_len = local_shard(torch.tensor(n_len, dtype=torch.int32),
                                P("data"), mesh)
        outs.append(partitioned_decode_attention(ql, kl, vl, n_len, mesh,
                                                 "model").numpy())
    return mesh.get_local_rank("data"), outs


def moe_rank(rank, n, mp, x):
    from repro_torch.configs import ARCHS, MeshConfig, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.transformer import Runtime
    from repro_torch.parallel.sharding import P, local_shard

    cfg = reduced(ARCHS["arctic-480b"], experts=8)
    mesh = make_mesh(MeshConfig(shape=(4, 2), axes=("data", "model")), "cpu")
    specs = {"router": P(None, None), "w_in": P("model", None, None),
             "w_gate": P("model", None, None), "w_out": P("model", None, None),
             "dense": {"w_in": P(None, "model"), "w_gate": P(None, "model"),
                       "w_out": P("model", None)}}
    p = {}
    for key, a in mp.items():
        names = key.strip("[]'").split("']['")
        t = torch.from_numpy(np.array(a))
        spec = specs[names[0]] if len(names) == 1 else specs[names[0]][
            names[1]]
        (p.setdefault(names[0], {}) if len(names) > 1 else p)[
            names[-1]] = local_shard(t, spec, mesh)
    xl = local_shard(torch.from_numpy(np.array(x)), P("data"), mesh)
    rt = Runtime(mesh_batch_axes=("data",), dp_size=4, moe_shardmap=True,
                 mesh=mesh)
    with torch.no_grad():
        y, aux = moe.moe_ffn(p, xl, cfg, rt)
    return (mesh.get_local_rank("data"), y.numpy(),
            aux["expert_load"].numpy(), float(aux["aux_loss"]),
            aux["capacity"])


def pipeline_rank(rank, n, w, xs, layouts):
    from repro_torch.configs import MeshConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_forward, stack_stages

    mesh = make_mesh(MeshConfig(shape=(4,), axes=("model",)), "cpu")
    x = torch.from_numpy(xs)

    def layer_fn(c, p):
        return torch.tanh(c @ p["w"])

    outs = []
    for lay in layouts:
        staged, mask = stack_stages({"w": torch.from_numpy(w)}, lay)
        outs.append(pipeline_forward({"w": staged["w"][rank]}, mask[rank],
                                     x, layer_fn, mesh).numpy())
    seq = x
    for i in range(w.shape[0]):
        seq = layer_fn(seq, {"w": torch.from_numpy(w[i])})
    return outs, seq.numpy()


def q8_rank(rank, n, g):
    from repro_torch.configs import MeshConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.collectives import all_reduce, \
        compressed_psum_grads

    mesh = make_mesh(MeshConfig(shape=(8,), axes=("data",)), "cpu")
    r = {"w": torch.zeros(1000)}
    outs = []
    for _ in range(2):
        o, r = compressed_psum_grads({"w": torch.from_numpy(g)}, r, mesh,
                                     ("data",))
        outs.append((o["w"].numpy(), r["w"].numpy()))
    # other gradients on each rank: against the exact sum
    mine = torch.from_numpy(g) * (rank + 1) - 0.003 * rank
    o, _ = compressed_psum_grads({"w": mine}, {"w": torch.zeros(1000)},
                                 mesh, ("data",))
    exact = all_reduce(mine, mesh, "data")
    return outs, o["w"].numpy(), exact.numpy(), mine.numpy()


def serve_rank(rank, n, arch, decode_attention, kind="cpu"):
    """One rank: the reduced ``arch`` served unsharded and over a (2, 2)
    mesh (tensor-parallel heads, batch over data, under
    ``decode_attention="partitioned"`` the caches' sequence over model)
    from the same seeded params: prefill, then decode steps at a shared
    position and at per-row positions. Returns this rank's rows of both
    paths' logits."""
    from repro_torch.configs import (ARCHS, MeshConfig, RunConfig,
                                     ShapeConfig, reduced)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Runtime, build
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime.steps import build_decode_step

    cfg = reduced(ARCHS[arch], experts=4)
    B, S, span = 4, 8, 16
    mesh_cfg = MeshConfig(shape=(2, 2), axes=("data", "model"))
    mesh = make_mesh(mesh_cfg, kind)
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("d", "decode", span, B),
                     mesh=mesh_cfg, param_dtype="float32",
                     attention_backend="dense",
                     decode_attention=decode_attention)
    dev = _device(kind)
    one = build(cfg, Runtime(attention_backend="dense"), device=dev)
    params = one.init_params(torch.Generator(device=dev).manual_seed(0))
    _, model = build_decode_step(rcfg, device=dev, mesh=mesh)
    local = shd.shard_tree(params, model.rt.param_specs, mesh)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if cfg.is_enc_dec:
        batch["audio_embeds"] = torch.randn((B, S, cfg.d_model),
                                            generator=g) * 0.5
    batch = {k: v.to(dev) for k, v in batch.items()}
    d = mesh.get_local_rank("data")
    rows = slice(d * B // 2, (d + 1) * B // 2)
    local_batch = {k: v[rows] for k, v in batch.items()}
    toks = torch.randint(0, cfg.vocab_size, (3, B, 1), generator=g).to(dev)
    out = {}
    with torch.no_grad():
        for name, m, p, b in (("one", one, params, batch),
                              ("mesh", model, local, local_batch)):
            logits, caches = m.prefill(p, b, span)
            out[name + "_cache"] = tuple(caches["layers"]["k"].shape)
            seen = [logits[rows] if name == "one" else logits]
            for t in range(2):
                tok = toks[t] if name == "one" else toks[t][rows]
                logits, caches = m.decode_step(p, caches, tok, S + t)
                seen.append(logits[rows] if name == "one" else logits)
            # per-row positions on both sides of the shards' boundary
            pos = torch.tensor([S + 2, 5, S + 1, 3], device=dev)
            pos = pos if name == "one" else pos[rows]
            tok = toks[2] if name == "one" else toks[2][rows]
            logits, _ = m.decode_step(p, caches, tok, pos)
            seen.append(logits[rows] if name == "one" else logits)
            out[name] = [t.cpu().numpy() for t in seen]
    return out


def count_step_rank(rank, n, rcfg):
    """One rank of a real sharded training step of ``rcfg`` on gloo,
    counted (``count_cost``): its flops, matrix-product flops, bytes,
    collective bytes by opcode with their groups' sizes, and kernel
    calls."""
    from repro_torch.core.cost import count_cost
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime.steps import build_train_step

    mesh = make_mesh(rcfg.mesh, "cpu")
    step, model, opt = build_train_step(rcfg, device="cpu", mesh=mesh)
    params = shd.shard_tree(model.init_params(
        torch.Generator().manual_seed(0)), model.rt.param_specs, mesh)
    state = opt.init(params)
    batch = SyntheticLM(rcfg.model, rcfg.shape.global_batch,
                        rcfg.shape.seq_len, seed=0,
                        device="cpu").batch_at(0)
    _, report = count_cost(step, params, state, batch)
    return {"flops": report.flops, "dot_flops": report.dot_flops,
            "bytes": report.bytes,
            "collectives": report.collective_summary(),
            "groups": sorted({(c.opcode, c.group_size)
                              for c in report.collectives}),
            "kernels": {k: v["calls"] for k, v in report.kernels.items()}}


def remesh_rank(rank, n, ckpt_in, ckpt_out, step_out, full, model_axis=2,
                save=True, kind="cpu"):
    """One rank of an elastic hop: restore the newest checkpoint of
    ``ckpt_in`` (None: start from ``full``) onto ``choose_mesh(n)`` as
    this rank's shards of ``{"w": (8, 8)}`` under P("data", "model"),
    then (``save``) save them sharded to ``ckpt_out`` at ``step_out``.
    Returns (restored step, this rank's shard, the shard ``full`` gives
    it)."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import P, local_shard
    from repro_torch.runtime.elastic import choose_mesh, remesh

    cfg = choose_mesh(n, prefer_model=model_axis)
    specs = {"w": P("data", "model")}
    want = torch.from_numpy(np.asarray(full))
    dev = _device(kind)
    if ckpt_in is None:
        mesh = make_mesh(cfg, kind)
        step, tree = None, {"w": local_shard(want, specs["w"], mesh).to(dev)}
    else:
        template = {"w": torch.empty(want.shape, dtype=want.dtype,
                                     device="meta")}
        mesh, out = remesh(ckpt_in, template, cfg, specs, device=kind)
        step, tree = out["step"], out["tree"]
    assert tree["w"].device == dev
    if save:
        ckpt.save(ckpt_out, step_out, tree, specs=specs, mesh=mesh)
    return (step, tree["w"].cpu().numpy(),
            local_shard(want, specs["w"], mesh).numpy(),
            tuple(mesh.shape))


def launcher_rank(rank, n, ckpt_a, ckpt_b, argv):
    """One rank of the training launcher under a 2-rank gloo world (the
    environment ``torchrun`` would set): 4 steps unbroken into
    ``ckpt_a``; then 2 steps into ``ckpt_b`` and a second launch that
    resumes there to step 4. Returns both runs' per-step metrics and the
    resumed run's ``resumed_from``."""
    import os

    from repro_torch.launch import train

    os.environ["WORLD_SIZE"] = str(n)
    base = [*argv, "--device", "cpu", "--ckpt-every", "100"]
    whole = train.main([*base, "--steps", "4", "--ckpt-dir", ckpt_a])
    train.main([*base, "--steps", "2", "--ckpt-dir", ckpt_b])
    resumed = train.main([*base, "--steps", "4", "--ckpt-dir", ckpt_b])
    return {"whole": whole.metrics, "resumed": resumed.metrics,
            "resumed_from": resumed.resumed_from,
            "checkpoints": resumed.checkpoints}
