"""The full-scale dry run (``repro_torch/launch/dryrun.py``): on ``meta``
tensors over fake ranks, against the JAX package's dry run and against
real steps.

* every cell's per-rank inputs have the shapes the reference's shardings
  give its devices (``NamedSharding.shard_shape``, no lowering), on both
  production meshes, from one JAX process with 512 host devices;
* at (2, 2) the dry run counts what a real 4-rank gloo step counts on
  rank 0: flops, matrix-product flops, bytes, collective bytes by opcode
  and group size, kernel calls;
* the parts it counts sum to ``count_cost`` of the training step itself;
* its memo of ``meta`` results changes no count and no peak, and a
  collective over one rank counts nothing;
* two full cells give records with the reference's keys, in time, with
  no CUDA and no tensor off ``meta``;
* every cell's model FLOPs equal the reference's.
"""
import json
import time

import pytest
import torch

from conftest import run_with_devices
from repro_torch.checkpoint.checkpoint import _leaves
from repro_torch.configs import MeshConfig, RunConfig, ShapeConfig, reduced
from repro_torch.core.cost import (CostReport, MemoryReport, _tensors,
                                   count_cost_and_peak)
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import run_with_ranks

import _torch_ranks

JAX_SHAPES = r"""
import json
import repro.launch.dryrun as dr   # sets the 512 host devices first
import jax
from repro.launch.cells import all_cells, cell_run_config
from repro.launch.mesh import make_production_mesh, set_mesh

def shapes(args, shardings):
    leaves = jax.tree.leaves(args)
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda s: isinstance(s, jax.sharding.Sharding))
    assert len(leaves) == len(shs)
    return [list(s.shard_shape(tuple(x.shape))) for x, s in zip(leaves, shs)]

out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    with set_mesh(mesh):
        for arch, shape in all_cells():
            rcfg = cell_run_config(arch, shape, multi_pod=mp)
            args, in_sh, _, _, _ = dr.input_specs(rcfg, mesh)
            kind = rcfg.shape.kind
            names = {"train": ("params", "opt", "batch"),
                     "prefill": ("params", "batch"),
                     "decode": ("params", "caches", "token")}[kind]
            cell = {n: shapes(a, s) for n, a, s in zip(names, args, in_sh)}
            if kind != "decode":
                cell["batch"] = {k: list(in_sh[-1][k].shard_shape(
                    tuple(args[-1][k].shape))) for k in args[-1]}
            out[f"{arch}|{shape}|{int(mp)}"] = cell
print("SHAPES" + json.dumps(out))
"""


def _shapes(tree) -> list:
    return [list(x.shape) if torch.is_tensor(x) else [] for x in
            _leaves(tree)]


def _port_shapes(arch, shape, multi_pod) -> dict:
    """The per-rank inputs the dry run gives rank 0 of a cell: params,
    optimizer state, the rows of the batch its step computes (a training
    step takes the global batch and picks them, ``local_rows``), caches
    and tokens."""
    from repro_torch.runtime.steps import local_rows

    rcfg = cells.cell_run_config(arch, shape, multi_pod=multi_pod)
    mesh = dryrun.fake_mesh(rcfg.mesh)
    _, args, model = dryrun.input_specs(rcfg, mesh)
    kind = rcfg.shape.kind
    if kind == "train":
        params, opt, batch = args
        rows = local_rows(batch, rcfg.microbatches, mesh,
                          model.rt.mesh_batch_axes)
        return {"params": _shapes(params), "opt": _shapes(opt),
                "batch": {k: list(v.shape) for k, v in rows.items()}}
    if kind == "prefill":
        params, batch = args
        return {"params": _shapes(params),
                "batch": {k: list(v.shape) for k, v in batch.items()}}
    params, caches, token, _ = args
    return {"params": _shapes(params), "caches": _shapes(caches),
            "token": [list(token.shape)]}


@pytest.fixture(scope="module")
def jax_shapes():
    out = run_with_devices(JAX_SHAPES, n_devices=512, timeout=900)
    line = next(ln for ln in out.splitlines() if ln.startswith("SHAPES"))
    return json.loads(line[len("SHAPES"):])


def test_every_cells_inputs_have_the_references_shard_shapes(jax_shapes):
    for mp in (False, True):
        for arch, shape in cells.all_cells():
            want = jax_shapes[f"{arch}|{shape}|{int(mp)}"]
            got = _port_shapes(arch, shape, mp)
            assert got.keys() == want.keys(), (arch, shape, mp)
            for key in want:
                assert got[key] == want[key], (arch, shape, mp, key)


# ---------------------------------------------- the count against real steps
SMALL = RunConfig(
    model=reduced(cells.get_arch("granite-3-8b"), layers=2, d_model=128,
                  d_ff=256, vocab=512),
    shape=ShapeConfig("t", "train", 64, 8),
    mesh=MeshConfig(shape=(2, 2), axes=("data", "model")),
    param_dtype="float32", attention_backend="kernel",
    exec_mode="streaming", microbatches=2)


def _summary(report) -> dict:
    return {"flops": report.flops, "dot_flops": report.dot_flops,
            "bytes": report.bytes,
            "collectives": report.collective_summary(),
            "groups": sorted({(c.opcode, c.group_size)
                              for c in report.collectives}),
            "kernels": {k: v["calls"] for k, v in report.kernels.items()}}


class _Devices(torch.utils._python_dispatch.TorchDispatchMode):
    """The devices of the results of every operation outside a kernel
    region that takes a ``meta`` tensor (the step's data; the mesh keeps
    its table of ranks on the host, as every ``DeviceMesh`` does)."""

    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.kernels import work
        out = func(*args, **(kwargs or {}))
        if not work.inside_kernel() and any(
                t.device.type == "meta" for t in _tensors((args, kwargs))):
            self.devices |= {t.device.type for t in _tensors(out)}
        return out


def test_the_count_at_2x2_equals_a_real_4_rank_gloo_step():
    real = run_with_ranks(_torch_ranks.count_step_rank, 4, SMALL,
                          timeout=300)
    mesh = dryrun.fake_mesh(SMALL.mesh)
    step, args, _ = dryrun.input_specs(SMALL, mesh)
    dryrun.warm_constants(SMALL.model)
    spy = _Devices()
    with spy:
        out, report, mem = count_cost_and_peak(step, *args)
    assert spy.devices == {"meta"}
    assert {t.device.type for t in _tensors((args, out))} == {"meta"}
    got = _summary(report)
    # every rank of the real step counts what the dry run counts for
    # rank 0 (even shards: the ranks do alike)
    assert [got] * 4 == real
    assert got["collectives"].keys() >= {"all-gather", "all-reduce",
                                         "reduce-scatter"}
    # groups of one axis (2 ranks) and, for the norm of leaves split over
    # both, of the whole mesh (4)
    assert {g for _, g in got["groups"]} == {2, 4}
    assert mem.peak_bytes > mem.argument_bytes > 0


def test_the_parts_of_train_step_sum_to_its_count():
    """On real CPU tensors, one device: the dry run's part-for-part step
    counts what ``count_cost(train_step)`` counts."""
    import dataclasses

    from repro_torch.core.cost import count_cost
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.steps import build_train_step

    rcfg = dataclasses.replace(SMALL, mesh=MeshConfig())
    reports = []
    for parts in (False, True):
        step, model, opt = build_train_step(rcfg, device="cpu")
        params = model.init_params(torch.Generator().manual_seed(0))
        state = opt.init(params)
        batch = SyntheticLM(rcfg.model, 8, 64, seed=0,
                            device="cpu").batch_at(0)
        fn = dryrun.train_parts(step, opt) if parts else step
        reports.append(_summary(count_cost(fn, params, state, batch)[1]))
    assert reports[0] == reports[1]


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_the_meta_memo_changes_no_count_and_no_peak(kind, monkeypatch):
    """The small cell counted with and without the memo of ``meta``
    results: the same counts and the same bytes held (a memo entry that
    made a view's output anew, as ``_unsafe_view``'s, would add them)."""
    import dataclasses

    from repro_torch.core import cost

    rcfg = SMALL if kind == "train" else dataclasses.replace(
        SMALL, shape=ShapeConfig("d", "decode", 64, 8))
    out = []
    for memo in (True, False):
        if not memo:
            monkeypatch.setattr(cost._MetaMemo, "run",
                                lambda self, f, a, k: (f(*a, **k), None))
        _, report, mem, _ = dryrun.count_cell(rcfg,
                                              dryrun.fake_mesh(rcfg.mesh))
        out.append((_summary(report), dataclasses.asdict(mem)))
    assert out[0] == out[1]


def test_a_collective_over_one_rank_counts_nothing():
    """An all-reduce over a group of one rank moves no bytes and is no
    collective; over two ranks it is one, operand and result counted."""
    from repro_torch.core.cost import count_cost
    from repro_torch.parallel import collectives as coll

    x = torch.empty((4, 8), device="meta")
    got = {}
    for n in (1, 2):
        mesh = dryrun.fake_mesh(MeshConfig(shape=(n,), axes=("data",)))
        group = coll.group_of(mesh, "data")
        _, got[n] = count_cost(lambda: coll.call(
            torch.distributed.all_reduce, x, group=group))
    assert got[1].collectives == [] and got[1].bytes == 0
    (c,) = got[2].collectives
    assert (c.opcode, c.bytes, c.group_size) == ("all-reduce", 128.0, 2)
    assert got[2].bytes == 2 * 128


# -------------------------------------------------------- full cells, keys
REF_KEYS = {"arch", "shape", "mesh", "devices", "exec_mode", "microbatches",
            "multi_pod", "memory", "roofline", "hlo"}
REF_MEMORY = {"argument_gb", "output_gb", "temp_gb", "alias_gb", "peak_gb"}
REF_HLO = {"flops_per_device", "dot_flops_per_device", "bytes_per_device",
           "collective_bytes", "collective_ici_bytes",
           "collective_breakdown", "n_collectives", "warnings"}


FULL_CELLS = [("granite-3-8b", "train_4k", False),
              ("arctic-480b", "decode_32k", True)]


@pytest.fixture(scope="module")
def full_cells(tmp_path_factory):
    """The two full cells, each counted once into one records directory:
    {(arch, shape): (record, this process's CPU seconds)}, and the
    directory. CPU seconds: on a runner shared with other tests the wall
    clock also counts the others' time."""
    d = tmp_path_factory.mktemp("dryrun_torch")
    out = {}
    for arch, shape, multi_pod in FULL_CELLS:
        t0 = time.process_time()
        rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                              results_dir=d)
        out[(arch, shape)] = (rec, time.process_time() - t0)
    return out, d


@pytest.mark.parametrize("arch,shape,multi_pod", FULL_CELLS)
def test_full_cells_complete_with_the_references_keys(full_cells, arch, shape,
                                                      multi_pod):
    cells_out, tmp_path = full_cells
    rec, took = cells_out[(arch, shape)]
    assert took < 60, f"{arch} {shape} took {took:.1f} CPU s"
    mesh = "2x16x16" if multi_pod else "16x16"
    saved = json.loads((tmp_path / f"{arch}_{shape}_{mesh}.json").read_text())
    assert saved == json.loads(json.dumps(rec))
    # the reference's keys, count_s in place of lower_s and compile_s
    assert REF_KEYS | {"count_s"} <= rec.keys()
    assert REF_MEMORY <= rec["memory"].keys()
    assert REF_HLO <= rec["hlo"].keys()
    assert rec["mesh"] == mesh and rec["devices"] == (512 if multi_pod
                                                      else 256)
    assert rec["counts_of"] == "rank 0"
    m = rec["memory"]
    assert m["peak_gb"] == pytest.approx(m["argument_gb"] + m["temp_gb"]
                                         + m["output_gb"] - m["alias_gb"])
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["hlo"]["n_collectives"] > 0
    assert rec["roofline"]["chip"].startswith("NVIDIA H100")
    kernels = set(rec["kernels"])
    assert "rmsnorm" in kernels
    if shape == "train_4k":
        assert {"flash_attention_lse", "flash_attention_dq",
                "flash_attention_dkv"} <= kernels
        assert rec["microbatches"] == 16
    assert not torch.cuda.is_initialized()


def test_model_flops_equal_the_references_for_every_cell():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_arch as jget_arch
    from repro.core.profiler import model_flops_for
    for arch, shape in cells.all_cells():
        rec = dryrun.record(arch, shape, cells.cell_run_config(arch, shape),
                            False, CostReport(), MemoryReport(), 0.0)
        got = rec["roofline"]["model_flops"]
        assert got == model_flops_for(jget_arch(arch), JSHAPES[shape])


def test_the_dry_run_scenarios_read_the_records(full_cells, tmp_path):
    """``efficiency/projected``, ``roofline/dryrun`` and
    ``deploy/precision_fullscale`` read the dry run's records; with none
    each yields the reference's "run the dry run first" record."""
    import repro_torch.bench.suites  # noqa: F401  (registers them)
    from repro_torch.bench import Workload
    from repro_torch.bench.scenario import REGISTRY

    _, d = full_cells
    names = ("efficiency/projected", "roofline/dryrun",
             "deploy/precision_fullscale")

    def run(name, where):
        wl = REGISTRY[name].workloads[0]
        wl = Workload(label=wl.label, arch=wl.arch,
                      knobs={**wl.knobs, "dir": str(where)})
        return list(REGISTRY[name].fn(wl))

    eff, roof, prec = (run(n, d) for n in names)
    assert [r.name for r in eff] == ["efficiency/granite-3-8b/projected"]
    assert eff[0].derived["tflops"] > 0 and eff[0].mesh == "16x16"
    assert [r.name for r in roof] == ["roofline/granite-3-8b/train_4k"]
    assert roof[0].derived["dom"] in ("compute", "memory", "collective")
    assert roof[0].derived["AI"] > 0
    assert [r.name for r in prec] == ["deploy/precision_fullscale_bf16"]
    assert prec[0].derived["memory_s"] > 0
    for name in names:
        (empty,) = run(name, tmp_path)
        assert empty.derived == {"note": "run launch/dryrun.py first"}
        assert empty.name.endswith("/no_dryrun_artifacts")


def test_the_dryrun_table(full_cells):
    from repro_torch.core.report import dryrun_table, load_dryrun_records

    _, d = full_cells
    recs = load_dryrun_records(d)
    assert [r["arch"] for r in recs] == ["granite-3-8b"]
    assert [r["arch"] for r in load_dryrun_records(d, "2x16x16")] == [
        "arctic-480b"]
    table = dryrun_table(recs).splitlines()
    assert table[0].endswith("| peak GB (of 80) |")
    assert table[2].startswith("| granite-3-8b | train_4k | 16x16 |")
