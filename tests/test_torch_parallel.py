"""The port's distribution layer on gloo ranks, held to the JAX package:
the counterparts of ``tests/test_parallel.py``.

* DP x TP at (4, 1), (2, 2), (1, 4): the sharded train step's loss within
  1e-4 of JAX's one-device loss (the reference's bound) and within 1e-5
  of the port's unsharded step; one AdamW step's params (gathered) and
  grad norm within 1e-5 of the unsharded step's; streaming (ZeRO-3) equal
  to resident within 1e-5;
* partitioned decode at cache_len S, 37, 5 and per-row lengths: within
  1e-5 of JAX's ``partitioned_decode_attention`` on the same (2, 4) mesh;
* serving over a (2, 2) mesh (TP heads, partitioned or simple decode):
  each rank's logits within 1e-5 of the one-device model's;
* ``moe_ffn_shardmap`` on a (4, 2) mesh against JAX's: outputs within
  1e-5, ``expert_load`` equal, ``aux_loss`` within 1e-6;
* ``pipeline_forward`` on 4 stages, layouts (2,2,2,2), (1,2,2,3),
  (1,1,1,5): within 1e-5 of JAX's and of the sequential stack;
* ``compressed_psum_grads`` over 8 ranks, twice (error feedback): the
  reduced gradients and residuals within one quantisation step per
  element of JAX's; with other gradients on each rank, within the
  quantisation error of the exact sum.

JAX runs its side in one subprocess with 8 host devices
(``conftest.run_with_devices``); the port each group of cases in one
world of ranks (``run_with_ranks``), each with its own timeout.
"""
import json
import os
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import run_with_devices
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.models import Runtime as JRuntime
from repro.models import build as jax_build
from repro.models.frontends import synth_batch
from repro_torch.launch.mesh import run_with_ranks

import _torch_ranks as ranks

RANK_TIMEOUT = 240
GRANITE = dict(d_model=128, vocab=512)
DECODE = dict(B=4, S=64, Hq=8, Hkv=2, D=32)
LENS = (64, 37, 5, (64, 20, 37, 1))
PP_LAYOUTS = ((2, 2, 2, 2), (1, 2, 2, 3), (1, 1, 1, 5))
PP = dict(L=8, D=32, M=6, MB=2, S=16)
MOE_X = (8, 16)

_JAX_SIDE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import ARCHS, MeshConfig, reduced
from repro.launch.mesh import make_mesh, set_mesh
from repro.models import moe as moe_mod
from repro.models.transformer import Runtime
from repro.parallel.collectives import (compressed_psum_grads,
                                        partitioned_decode_attention)
from repro.parallel.pipeline import pipeline_forward, stack_stages

out_path = sys.argv[1]
cfgs = json.loads(sys.argv[2])
res = {}
rng = np.random.default_rng(0)

# ---- partitioned decode on (2, 4): batch over data, sequence over model
d = cfgs["decode"]
B, S, Hq, Hkv, D = d["B"], d["S"], d["Hq"], d["Hkv"], d["D"]
q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
res.update(dec_q=q, dec_k=k, dec_v=v)
mesh = make_mesh(MeshConfig(shape=(2, 4), axes=("data", "model")))
for i, n in enumerate(cfgs["lens"]):
    n = jnp.asarray(n, jnp.int32)
    with set_mesh(mesh):
        o = jax.jit(lambda q, k, v, n: partitioned_decode_attention(
            q, k, v, n, batch_axes=("data",)))(q, k, v, n)
    res[f"dec_out{i}"] = np.asarray(o)

# ---- expert-parallel MoE on (4, 2)
cfg = reduced(ARCHS["arctic-480b"], experts=8)
mp = moe_mod.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
x = (jax.random.normal(jax.random.PRNGKey(1),
                       tuple(cfgs["moe_x"]) + (cfg.d_model,)) * 0.5)
rt = Runtime(act_spec=P("data", None, None), mesh_batch_axes=("data",),
             dp_size=4, moe_shardmap=True)
mesh = make_mesh(MeshConfig(shape=(4, 2), axes=("data", "model")))
with set_mesh(mesh):
    y, aux = jax.jit(lambda p, x: moe_mod.moe_ffn(p, x, cfg, rt))(mp, x)
for name, a in jax.tree_util.tree_flatten_with_path(mp)[0]:
    res["moe_p" + jax.tree_util.keystr(name)] = np.asarray(a)
res.update(moe_x=np.asarray(x), moe_y=np.asarray(y),
           moe_load=np.asarray(aux["expert_load"]),
           moe_aux=np.asarray(aux["aux_loss"]),
           moe_cap=np.asarray(aux["capacity"]))

# ---- GPipe on 4 stages
pp = cfgs["pp"]
w = (rng.standard_normal((pp["L"], pp["D"], pp["D"])) * 0.1).astype(np.float32)
xs = rng.standard_normal((pp["M"], pp["MB"], pp["S"], pp["D"])).astype(
    np.float32)
res.update(pp_w=w, pp_x=xs)
mesh = make_mesh(MeshConfig(shape=(4,), axes=("model",)))
layer_fn = lambda c, p: jnp.tanh(c @ p["w"])
for i, lay in enumerate(cfgs["pp_layouts"]):
    staged, mask = stack_stages({"w": jnp.asarray(w)}, lay)
    with set_mesh(mesh):
        o = jax.jit(lambda s, m, xx: pipeline_forward(s, m, xx, layer_fn))(
            staged, mask, jnp.asarray(xs))
    res[f"pp_out{i}"] = np.asarray(o)

# ---- int8 error-feedback all-reduce over 8 data shards, twice
g = (rng.standard_normal(1000) * 0.01).astype(np.float32)
res["q8_g"] = g
mesh = make_mesh(MeshConfig(shape=(8,), axes=("data",)))
r = {"w": jnp.zeros(1000)}
for i in range(2):
    with set_mesh(mesh):
        o, r = jax.jit(lambda g, r: compressed_psum_grads(
            g, r, data_axes=("data",)))({"w": jnp.asarray(g)}, r)
    res[f"q8_out{i}"] = np.asarray(o["w"])
    res[f"q8_res{i}"] = np.asarray(r["w"])
np.savez(out_path, **res)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_side():
    cfgs = {"decode": DECODE, "lens": [list(n) if isinstance(n, tuple)
                                       else n for n in LENS],
            "moe_x": list(MOE_X), "pp": PP,
            "pp_layouts": [list(x) for x in PP_LAYOUTS]}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "jax.npz")
        code = _JAX_SIDE.replace("sys.argv[1]", repr(path)).replace(
            "sys.argv[2]", repr(json.dumps(cfgs)))
        run_with_devices(code, n_devices=8, timeout=600)
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


# ------------------------------------------------------------- DP x TP
def _granite_case():
    cfg = jax_reduced(JAX_ARCHS["granite-3-8b"], **GRANITE)
    model = jax_build(cfg, JRuntime(attention_backend="dense"), jnp.float32)
    params = model.init_params(jax.random.PRNGKey(0))
    batch = synth_batch(cfg, 4, 32, kind="train")
    loss, _ = jax.jit(model.loss)(params, batch)
    return (jax.tree.map(np.asarray, params),
            {k: np.asarray(v) for k, v in batch.items()}, float(loss))


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_dp_tp_matches_single_device(shape):
    params, batch, jax_loss = _granite_case()
    out = run_with_ranks(ranks.dp_tp_rank, 4, shape, params, batch,
                         timeout=RANK_TIMEOUT)[0]
    loss0, gn0, p0 = out["unsharded"]
    assert abs(loss0 - jax_loss) < 1e-4
    for mode in ("resident", "streaming"):
        loss, gn, p = out[mode]
        assert abs(loss - jax_loss) < 1e-4, (mode, loss, jax_loss)
        assert abs(loss - loss0) < 1e-5, (mode, loss, loss0)
        assert abs(gn - gn0) < 1e-5 * max(1.0, gn0), (mode, gn, gn0)
        err = max(float(np.abs(a - b).max()) for a, b in zip(p, p0))
        assert err < 1e-5, (mode, err)
    res, stream = out["resident"], out["streaming"]
    assert abs(res[0] - stream[0]) < 1e-5
    assert max(float(np.abs(a - b).max())
               for a, b in zip(res[2], stream[2])) < 1e-5


# ------------------------------------------------- partitioned decode


def test_partitioned_decode_matches_jax(jax_side):
    j = jax_side
    results = run_with_ranks(ranks.decode_rank, 8, j["dec_q"], j["dec_k"],
                             j["dec_v"], LENS, timeout=RANK_TIMEOUT)
    rows = DECODE["B"] // 2
    for d, outs in results:
        for i, o in enumerate(outs):
            want = j[f"dec_out{i}"][d * rows:(d + 1) * rows]
            err = float(np.abs(o - want).max())
            assert err < 1e-5, (LENS[i], err)


# ------------------------------------------------- sharded serving
@pytest.mark.parametrize("decode_attention", ["partitioned", "simple"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "whisper-large-v3",
                                  "arctic-480b"])
def test_sharded_serving_matches_one_device(arch, decode_attention):
    """The reduced model served over a (2, 2) mesh -- tensor-parallel
    heads and MLP (experts: expert-parallel), batch over data, the caches
    sequence-sharded over model where the decode is partitioned (cross
    caches too) -- gives each rank's rows of the one-device logits,
    prefill and decode at shared and per-row positions, within 1e-5."""
    results = run_with_ranks(ranks.serve_rank, 4, arch, decode_attention,
                             timeout=RANK_TIMEOUT)
    L, B, S, H, D = results[0]["one_cache"]
    seq = S // 2 if decode_attention == "partitioned" else S
    for out in results:
        assert out["mesh_cache"] == (L, B // 2, seq, H, D)
        for a, b in zip(out["mesh"], out["one"]):
            assert a.shape == b.shape
            assert float(np.abs(a - b).max()) < 1e-5


# ----------------------------------------------------- expert-parallel MoE


def test_moe_shardmap_matches_jax(jax_side):
    j = jax_side
    mp = {k[len("moe_p"):]: v for k, v in j.items() if k.startswith("moe_p")}
    results = run_with_ranks(ranks.moe_rank, 8, mp, j["moe_x"],
                             timeout=RANK_TIMEOUT)
    rows = MOE_X[0] // 4
    for d, y, load, aux, cap in results:
        err = float(np.abs(y - j["moe_y"][d * rows:(d + 1) * rows]).max())
        assert err < 1e-5, err
        np.testing.assert_array_equal(load, j["moe_load"])
        assert abs(aux - float(j["moe_aux"])) < 1e-6
        assert cap == int(j["moe_cap"])
    assert float(j["moe_load"].sum()) > 0


# -------------------------------------------------------------- pipeline


def test_pipeline_matches_jax_and_sequential(jax_side):
    j = jax_side
    results = run_with_ranks(ranks.pipeline_rank, 4, j["pp_w"], j["pp_x"],
                             PP_LAYOUTS, timeout=RANK_TIMEOUT)
    for outs, seq in results:
        for i, o in enumerate(outs):
            assert float(np.abs(o - j[f"pp_out{i}"]).max()) < 1e-5
            assert float(np.abs(o - seq).max()) < 1e-5


# -------------------------------------------------- int8 all-reduce


def _steps(ref, n=8):
    """Per element, the int8 step of its chunk of ``ref`` (the reduced
    result, which holds each chunk's largest code 127 times its scale)."""
    c = -(-ref.shape[0] // n)
    pad = np.pad(np.abs(ref), (0, n * c - ref.shape[0]))
    return np.repeat(pad.reshape(n, c).max(1) / 127.0, c)[:ref.shape[0]]


def test_compressed_allreduce_matches_jax(jax_side):
    j = jax_side
    results = run_with_ranks(ranks.q8_rank, 8, j["q8_g"], timeout=RANK_TIMEOUT)
    # with other gradients on each rank: each rank's phase-1 error is at
    # most half its int8 step, the phase-2 error half the sum's step
    phase1 = sum(float(np.abs(r[3]).max()) for r in results) / 127.0
    for outs, o, exact, _ in results:
        for i, (out, res) in enumerate(outs):
            step = _steps(j[f"q8_out{i}"])
            assert np.all(np.abs(out - j[f"q8_out{i}"]) <= step + 1e-12)
            assert np.all(np.abs(res - j[f"q8_res{i}"]) <= step + 1e-12)
        assert float(np.abs(outs[0][1]).max()) > 0   # residual captured
        assert np.all(np.abs(o - exact) <= _steps(exact) + phase1)
