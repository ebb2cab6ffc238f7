"""The port's sharding rules (``repro_torch/parallel/sharding.py``) equal
the JAX package's (``repro/parallel/sharding.py``) spec for spec: every
parameter leaf of every config (``param_pspecs``), the decode caches
(``cache_pspecs``), the AdamW state with f32 and blockwise-int8 moments
(``opt_state_shardings``), ``batch_spec``/``act_pspec`` and
``_fit_spec``, on the paper's (16, 16) and (2, 16, 16) meshes, in the
resident and streaming modes. Shapes only: JAX's from ``jax.eval_shape``,
the port's from ``meta`` tensors, so full-size configs cost no memory.
Also ``shard_tree``/``local_shard`` on a one-process stand-in mesh.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import MeshConfig as JMeshConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import SHAPES as JAX_SHAPES
from repro.models import Runtime as JRuntime
from repro.models import build as jax_build
from repro.optim.adamw import AdamW as JAdamW
from repro.parallel import sharding as jshd
from repro_torch.configs import ARCHS, SHAPES, MeshConfig, RunConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.model import abstract_params
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import sharding as shd

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MODES = ("resident", "streaming")
CACHE_B, CACHE_S = 16, 4096


def _flat(tree, prefix=()):
    """{path: leaf} of nested dicts and named tuples (JAX's Q8, the
    port's Q8, AdamWState)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if hasattr(tree, "_fields") and not isinstance(tree, (PartitionSpec,
                                                           shd.P)):
        out = {}
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), prefix + (k,)))
        return out
    return {prefix: tree}


def _spec(s):
    """A spec as a plain tuple: JAX's PartitionSpec, a NamedSharding's
    spec, or the port's P."""
    if hasattr(s, "spec"):
        s = s.spec
    return tuple(s)


def _same(jtree, ttree):
    j = {k: _spec(v) for k, v in _flat(jtree).items()}
    t = {k: _spec(v) for k, v in _flat(ttree).items()}
    assert j.keys() == t.keys()
    bad = {k: (j[k], t[k]) for k in j if j[k] != t[k]}
    assert not bad, bad
    return len(j)


def _rcfgs(arch, mesh, mode):
    shape, axes = MESHES[mesh]
    jr = JRunConfig(model=JAX_ARCHS[arch], shape=JAX_SHAPES["train_4k"],
                    mesh=JMeshConfig(shape=shape, axes=axes), exec_mode=mode)
    tr = RunConfig(model=ARCHS[arch], shape=SHAPES["train_4k"],
                   mesh=MeshConfig(shape=shape, axes=axes), exec_mode=mode)
    return jr, tr


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    model = jax_build(JAX_ARCHS[arch], JRuntime(), jnp.float32)
    params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    caches = jax.eval_shape(lambda: model.cache_init(CACHE_B, CACHE_S))
    return params, caches


def _port_caches(cfg):
    caches = {"layers": tfm.cache_init(cfg, cfg.num_layers, CACHE_B, CACHE_S,
                                       torch.float32, "meta")}
    if cfg.is_enc_dec:
        shape = (cfg.num_layers, CACHE_B, CACHE_S, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        caches["cross"] = {n: torch.empty(shape, device="meta")
                           for n in ("ck", "cv")}
    return caches


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_cache_specs_match_jax(arch, mesh, mode):
    jr, tr = _rcfgs(arch, mesh, mode)
    jparams, jcaches = _jax_shapes(arch)
    tparams = abstract_params(ARCHS[arch])
    n = _same(jshd.param_pspecs(jparams, jr.model, jr),
              shd.param_pspecs(tparams, tr.model, tr))
    assert n == len(jax.tree.leaves(jparams))
    for decode in ("partitioned", "simple"):
        _same(jshd.cache_pspecs(jcaches, jr.model,
                                jr.replace(decode_attention=decode), CACHE_B),
              shd.cache_pspecs(_port_caches(ARCHS[arch]), tr.model,
                               tr.replace(decode_attention=decode), CACHE_B))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_state_specs_match_jax(arch, mesh, state_dtype, mode):
    jr, tr = _rcfgs(arch, mesh, mode)
    jparams, _ = _jax_shapes(arch)
    jopt = JAdamW(lr_fn=lambda s: 0.0, state_dtype=state_dtype)
    jstate = jax.eval_shape(jopt.init, jparams)
    shape, axes = MESHES[mesh]
    jmesh = AbstractMesh(shape, axes)
    jspecs = jshd.opt_state_shardings(
        jstate, jshd.param_pspecs(jparams, jr.model, jr), jmesh, jr.mesh)
    tparams = abstract_params(ARCHS[arch])
    tstate = AdamW(lr_fn=lambda s: 0.0, state_dtype=state_dtype).init(
        tparams)
    tspecs = shd.opt_state_shardings(
        tstate, shd.param_pspecs(tparams, tr.model, tr), tr.mesh)
    if state_dtype == "int8":      # blockwise moments: q and scale specs
        assert any(k[-1] == "scale" for k in _flat(tspecs.m))
    _same({"step": jspecs.step, "master": jspecs.master, "m": jspecs.m,
           "v": jspecs.v},
          {"step": tspecs.step, "master": tspecs.master, "m": tspecs.m,
           "v": tspecs.v})


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_act_specs_match_jax(mesh):
    shape, axes = MESHES[mesh]
    jm, tm = JMeshConfig(shape=shape, axes=axes), MeshConfig(shape=shape,
                                                             axes=axes)
    for gb in (1, 2, 8, 16, 32, 64, 96, 256, 512, 1024):
        for excl in ((), ("pod",)):
            assert jshd.batch_spec(jm, gb, excl) == shd.batch_spec(tm, gb,
                                                                   excl)
            assert tuple(jshd.act_pspec(jm, gb, excl)) == tuple(
                shd.act_pspec(tm, gb, excl))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fit_spec_matches_jax(mesh):
    shape, axes = MESHES[mesh]
    jm, tm = JMeshConfig(shape=shape, axes=axes), MeshConfig(shape=shape,
                                                             axes=axes)
    rng = np.random.default_rng(0)
    entries = [None, "data", "model", "pod", ("pod", "data"),
               ("pod", "model"), ("data",)]
    for _ in range(200):
        nd = int(rng.integers(1, 5))
        spec = [entries[int(rng.integers(len(entries)))] for _ in range(nd)]
        dims = [int(rng.choice([1, 2, 8, 24, 32, 100, 512, 1600]))
                for _ in range(nd)]
        assert tuple(jshd._fit_spec(PartitionSpec(*spec), dims, jm)) == \
            tuple(shd._fit_spec(shd.P(*spec), dims, tm))


class _Mesh:
    """A stand-in for a DeviceMesh: one rank's coordinates."""

    def __init__(self, shape, axes, coords):
        self.shape, self.mesh_dim_names, self.coords = shape, axes, coords

    def size(self, i):
        return self.shape[i]

    def get_local_rank(self, a):
        return self.coords[self.mesh_dim_names.index(a)]


def test_shard_tree_cuts_each_ranks_block():
    """Every rank's blocks of a full tensor, reassembled, give it back;
    a tuple entry puts its first axis outermost, as JAX does."""
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    spec = shd.P(("pod", "data"), None, "model")
    blocks = {}
    for p in range(2):
        for d in range(2):
            for m in range(2):
                mesh = _Mesh(shape, axes, (p, d, m))
                blocks[(p, d, m)] = shd.shard_tree({"w": x}, {"w": spec},
                                                   mesh)["w"]
    for (p, d, m), b in blocks.items():
        assert b.shape == (2, 6, 2) and b.is_contiguous()
        row = (p * 2 + d) * 2
        assert torch.equal(b, x[row:row + 2, :, m * 2:m * 2 + 2])


def test_production_meshes_match_jax():
    from repro.launch.mesh import mesh_config as jax_mesh_config
    from repro_torch.launch.mesh import mesh_config
    for multi in (False, True):
        got, want = mesh_config(multi_pod=multi), jax_mesh_config(
            multi_pod=multi)
        assert (got.shape, got.axes) == (want.shape, want.axes)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_int8_quantize_matches_jax(scale):
    from repro.parallel.collectives import int8_quantize as jax_q8
    from repro_torch.parallel.collectives import int8_quantize
    x = (np.random.default_rng(0).standard_normal(4099) * scale).astype(
        np.float32)
    jq, js = jax_q8(jnp.asarray(x))
    q, s = int8_quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == pytest.approx(float(js), rel=1e-7)


def test_make_runtime_refuses_a_mesh_other_than_the_runs():
    """The specs follow the run config's mesh: a DeviceMesh of another
    shape or axis names is refused rather than sharded by wrong specs."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.runtime.steps import make_runtime
    rcfg = RunConfig(model=ARCHS["granite-3-8b"],
                     shape=ShapeConfig("t", "train", 128, 4),
                     mesh=MeshConfig(shape=(2, 2), axes=("data", "model")))
    rt = make_runtime(rcfg, mesh=_Mesh((2, 2), ("data", "model"), (0, 0)))
    assert rt.mesh_batch_axes == ("data",) and rt.dp_size == 2
    assert tuple(rt.param_specs["layers"]["attn"]["wq"]) == (
        None, None, "model")
    for shape, axes in (((4, 1), ("data", "model")),
                        ((2, 2), ("model", "data"))):
        with pytest.raises(ValueError, match="not the run's"):
            make_runtime(rcfg, mesh=_Mesh(shape, axes, (0, 0)))
