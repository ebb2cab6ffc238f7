"""Elastic re-meshing of sharded checkpoints (``runtime/elastic.py::
remesh``, the sharded save and restore of ``checkpoint/checkpoint.py``)
against the JAX package's:

* the counterparts of the reference's remesh tests: a checkpoint saved
  from 8 gloo ranks on a (4, 2) mesh restores onto 4 ranks, and back onto
  8, bit for bit, each rank holding its own block;
* ``choose_mesh`` on awkward device counts equals the reference's;
* a checkpoint the JAX package saves from an 8-device mesh restores
  through ``remesh`` onto 4 ranks, and a 4-rank checkpoint of the port
  restores through the reference's ``restore_latest``, bit for bit;
* the training launcher on 2 gloo ranks with ``--ckpt-dir`` resumes equal
  to an unbroken run.
"""
import numpy as np
import pytest

from conftest import run_with_devices
from repro_torch.launch.mesh import run_with_ranks

import _torch_ranks

WANT = np.arange(64.0).reshape(8, 8)

JAX_SAVE = """
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint import checkpoint as ckpt
from repro.runtime.elastic import choose_mesh
from repro.launch.mesh import make_mesh
from jax.sharding import NamedSharding, PartitionSpec as P

m8 = make_mesh(choose_mesh(8, prefer_model=2))
tree = {"w": jax.device_put(jnp.asarray(np.arange(64.0).reshape(8, 8)),
                            NamedSharding(m8, P("data", "model")))}
ckpt.save(%r, 7, tree)
print("SAVED")
"""


@pytest.fixture(scope="module")
def hops(tmp_path_factory):
    """8 -> 4 -> 8 ranks: a checkpoint saved sharded from 8 gloo ranks on
    (4, 2) restores onto 4 ranks on (2, 2), which restore the JAX
    package's 8-device checkpoint too and save their shards again; that
    checkpoint restores onto 8 ranks. Returns each hop's per-rank
    results and the directories."""
    d = tmp_path_factory.mktemp("elastic")
    dirs = {k: str(d / k) for k in ("d8", "d4", "jax")}
    assert "SAVED" in run_with_devices(JAX_SAVE % dirs["jax"], n_devices=8)
    first = run_with_ranks(_torch_ranks.remesh_rank, 8, None, dirs["d8"], 5,
                           WANT, timeout=300)
    shrink = run_with_ranks(_torch_ranks.remesh_rank, 4, dirs["d8"],
                            dirs["d4"], 6, WANT, timeout=300)
    # the JAX package keeps the array in f32 (no x64)
    from_jax = run_with_ranks(_torch_ranks.remesh_rank, 4, dirs["jax"], None,
                              0, WANT.astype(np.float32), 2, False,
                              timeout=300)
    grow = run_with_ranks(_torch_ranks.remesh_rank, 8, dirs["d4"], None, 0,
                          WANT, 2, False, timeout=300)
    return {"first": first, "shrink": shrink, "from_jax": from_jax,
            "grow": grow, "dirs": dirs}


def _bit_equal(results, step):
    for got_step, got, want, _ in results:
        assert got_step == step
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_elastic_remesh(hops):
    """A checkpoint saved from 8 ranks on (4, 2) restores onto 4 ranks on
    (2, 2): each rank holds its (4, 4) block of the full array."""
    assert {r[3] for r in hops["first"]} == {(4, 2)}
    _bit_equal(hops["shrink"], 5)
    assert {r[3] for r in hops["shrink"]} == {(2, 2)}
    assert {r[1].shape for r in hops["shrink"]} == {(4, 4)}
    blocks = sorted(r[1].tobytes() for r in hops["shrink"])
    assert len(set(blocks)) == 4          # four distinct blocks


def test_choose_mesh_splits():
    """``choose_mesh`` on awkward device counts, as the reference's."""
    from repro.runtime.elastic import choose_mesh as jax_choose_mesh
    from repro_torch.runtime.elastic import choose_mesh

    def shape(n, **kw):
        cfg = choose_mesh(n, **kw)
        assert cfg.axes == ("data", "model")
        d, m = cfg.shape
        assert d * m == n, f"{cfg.shape} does not cover {n} devices"
        assert cfg.shape == jax_choose_mesh(n, **kw).shape
        return cfg.shape

    assert shape(1) == (1, 1)
    assert shape(8) == (4, 2)
    assert shape(16) == (4, 4)
    assert shape(6) == (3, 2)
    assert shape(12) == (6, 2)
    assert shape(7) == (7, 1)
    assert shape(4, prefer_model=16) == (1, 4)
    assert shape(6, prefer_model=3) == (2, 3)
    assert shape(8, prefer_model=3) == (8, 1)


def test_elastic_remesh_round_trip(hops):
    """8 -> 4 -> 8: each hop restores the full logical array bit for bit
    and lays it out across the hop's ranks."""
    _bit_equal(hops["shrink"], 5)
    _bit_equal(hops["grow"], 6)
    assert {r[3] for r in hops["grow"]} == {(4, 2)}
    assert {r[1].shape for r in hops["grow"]} == {(2, 4)}
    whole = np.zeros_like(WANT)
    for (_, got, _, _), r in zip(hops["grow"], range(8)):
        d, m = divmod(r, 2)
        whole[2 * d:2 * d + 2, 4 * m:4 * m + 4] = got
    assert whole.tobytes() == WANT.tobytes()


def test_a_jax_checkpoint_restores_through_remesh(hops):
    """The JAX package's checkpoint of an 8-device mesh, onto 4 ranks."""
    _bit_equal(hops["from_jax"], 7)


def test_a_port_checkpoint_restores_through_the_references_restore(hops):
    """The 4 ranks' sharded save is the reference's layout: its
    ``restore_latest`` reads the full array back."""
    import jax.numpy as jnp

    from repro.checkpoint import checkpoint as jax_ckpt

    step, tree = jax_ckpt.restore_latest(hops["dirs"]["d4"],
                                         {"w": jnp.zeros((8, 8))})
    assert step == 6
    # the saved leaf is the full f64 array; the reference casts it to its
    # target's f32
    saved = np.load(f"{hops['dirs']['d4']}/step_6/leaf_0.npy")
    assert saved.dtype == WANT.dtype and saved.tobytes() == WANT.tobytes()
    got = np.asarray(tree["w"])
    want = WANT.astype(np.float32)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_the_sharded_launcher_resumes_equal_to_an_unbroken_run(tmp_path):
    """``launch/train.py`` on 2 gloo ranks with ``--ckpt-dir``: 2 steps,
    then a second launch on to 4, resumes after step 1 and gives the
    unbroken run's losses and grad norms bit for bit."""
    argv = ["--arch", "granite-3-8b", "--layers", "2", "--d-model", "64",
            "--batch", "4", "--seq", "16"]
    out = run_with_ranks(_torch_ranks.launcher_rank, 2, str(tmp_path / "a"),
                         str(tmp_path / "b"), argv, timeout=300)[0]
    assert out["resumed_from"] == 1
    assert out["checkpoints"] == [3]
    for a, b in zip(out["resumed"], out["whole"][2:]):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    assert len(out["resumed"]) == 2
    step3 = tmp_path / "a" / "step_3"
    assert (step3 / "_COMMITTED").exists()
    # the files are the full logical leaves: both runs' final states agree
    for f in sorted(step3.glob("leaf_*.npy")):
        a, b = np.load(f), np.load(tmp_path / "b" / "step_3" / f.name)
        assert a.tobytes() == b.tobytes(), f.name
