"""Per-(arch x shape) run configuration of the dry run: execution mode,
microbatch count and attention chunk, the counterpart of
``repro/launch/cells.py`` and field for field its choices.

The reference chose them so that every cell fits a 16 GB chip on the
production mesh. The port keeps them unchanged: the dry run
(:mod:`repro_torch.launch.dryrun`) reports how each cell sits against the
H100's 80 GB, and changes none of them.
"""
from __future__ import annotations

from repro_torch.configs import ARCHS, SHAPES, MeshConfig, RunConfig, get_arch
from repro_torch.launch.mesh import mesh_config


def default_microbatches(arch, shape, mesh_cfg: MeshConfig) -> int:
    if shape.kind != "train":
        return 1
    data = mesh_cfg.data_size
    # one sequence per data shard per microbatch for wide models; more for
    # narrow ones. Must divide the global batch.
    if arch.d_model >= 4096:
        per_shard = 1
    elif arch.d_model >= 2048:
        per_shard = 2
    else:
        per_shard = 4
    mb_size = min(shape.global_batch, per_shard * data)
    n_mb = max(1, shape.global_batch // mb_size)
    while shape.global_batch % n_mb:
        n_mb -= 1
    return n_mb


def cell_run_config(arch_name: str, shape_name: str, *,
                    multi_pod: bool = False,
                    exec_mode: str = "streaming",
                    attention_backend: str = "chunked") -> RunConfig:
    arch = get_arch(arch_name)
    shape = SHAPES[shape_name]
    mesh = mesh_config(multi_pod=multi_pod)
    chunk = 2048 if shape.seq_len > 8192 else 1024
    # 400-480B MoE: f32 AdamW state alone is ~22 GB a 16 GB chip, so these
    # archs train with blockwise-int8 state, no master copy and bf16
    # gradient sums (8-bit-Adam-style memory policy)
    big = arch.param_count() > 2e11
    return RunConfig(
        model=arch,
        shape=shape,
        mesh=mesh,
        exec_mode=exec_mode,
        microbatches=default_microbatches(arch, shape, mesh),
        remat=True,
        attention_backend=attention_backend,
        attention_chunk=chunk,
        decode_attention="partitioned",
        opt_state_dtype="int8" if big else "float32",
        opt_master=not big,
        grad_accum_dtype="bfloat16" if big else "float32",
    )


def valid_cell(arch_name: str, shape_name: str) -> bool:
    arch = get_arch(arch_name)
    if shape_name == "long_500k" and not arch.sub_quadratic:
        return False   # noted skip: full-attention archs
    return True


def all_cells():
    for arch_name in ARCHS:
        for shape_name in SHAPES:
            if valid_cell(arch_name, shape_name):
                yield arch_name, shape_name
