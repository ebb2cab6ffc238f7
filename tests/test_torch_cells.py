"""The dry run's cells (``repro_torch/launch/cells.py``) against the JAX
package's (``repro/launch/cells.py``): the same cells, and for each on
both production meshes the same run configuration, field by field."""
import dataclasses

import pytest

from repro.launch import cells as jax_cells
from repro_torch.launch import cells


def _fields(rcfg) -> dict:
    """A run configuration as plain values (nested configs as dicts)."""
    return dataclasses.asdict(rcfg)


def test_cells_equal_the_references_and_number_32():
    ours = list(cells.all_cells())
    assert ours == list(jax_cells.all_cells())
    assert len(ours) == 32
    # the noted skips: long_500k of every full-attention arch
    from repro_torch.configs import ARCHS, SHAPES
    skipped = [(a, s) for a in ARCHS for s in SHAPES
               if not cells.valid_cell(a, s)]
    assert len(skipped) == 8 and {s for _, s in skipped} == {"long_500k"}


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_cell_run_config_equals_the_reference_field_by_field(multi_pod):
    for arch, shape in cells.all_cells():
        got = _fields(cells.cell_run_config(arch, shape,
                                            multi_pod=multi_pod))
        want = _fields(jax_cells.cell_run_config(arch, shape,
                                                 multi_pod=multi_pod))
        assert got.keys() == want.keys(), (arch, shape)
        for key in want:
            assert got[key] == want[key], (arch, shape, key)


def test_big_models_take_the_references_memory_policy():
    """int8 optimizer state, no master copy and bf16 gradient sums above
    2e11 parameters; partitioned decode and the attention chunk always."""
    from repro_torch.configs import get_arch
    for arch, shape in cells.all_cells():
        rcfg = cells.cell_run_config(arch, shape)
        big = get_arch(arch).param_count() > 2e11
        assert rcfg.opt_state_dtype == ("int8" if big else "float32")
        assert rcfg.opt_master is (not big)
        assert rcfg.grad_accum_dtype == ("bfloat16" if big else "float32")
        assert rcfg.decode_attention == "partitioned"
        assert rcfg.attention_chunk == (2048 if rcfg.shape.seq_len > 8192
                                        else 1024)


def test_default_microbatches_divide_the_global_batch():
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch.mesh import mesh_config
    for arch, shape in cells.all_cells():
        for mp in (False, True):
            mesh = mesh_config(multi_pod=mp)
            n = cells.default_microbatches(get_arch(arch), SHAPES[shape],
                                           mesh)
            assert SHAPES[shape].global_batch % n == 0
            assert n == jax_cells.default_microbatches(
                jax_cells.get_arch(arch), jax_cells.SHAPES[shape],
                jax_cells.mesh_config(multi_pod=mp))
