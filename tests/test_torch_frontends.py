"""The port's frontend stubs and position embeddings against the JAX
package's: the synthetic batches of the vision and audio stubs bit for
bit (``models/frontends.py::synth_batch``, ``SyntheticLM.batch_at``),
the bf16 rounding they share, M-RoPE with a (t, h, w) position grid at
full and reduced head dims, and whisper's sinusoidal embeddings.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import frontends as jax_frontends
from repro.models import layers as jax_layers
from repro_torch.configs import get_arch, reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import frontends, layers

torch.set_num_threads(2)
FRONTEND_ARCHS = ["whisper-large-v3", "qwen2-vl-72b",
                  "llama4-maverick-400b-a17b"]


def _bits(a) -> np.ndarray:
    """The raw bits of a JAX array or a tensor, for exact comparison."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_batch(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


def test_bf16_rounding_matches_jax():
    """float64 -> bf16 as ``jnp.asarray(x, jnp.bfloat16)`` rounds it: to
    f32 first, then to bf16, both to nearest even. The first values are
    the double-rounding cases: 1 + 2^-8 + 2^-30 is above the bf16 tie
    in float64 but rounds onto it in f32, then to even (1.0)."""
    tie = 1 + 2 ** -8 + 2 ** -30
    rng = np.random.default_rng(0)
    x = np.concatenate([[tie, -tie, 0.02 * tie, 3 * 2 ** -133, 1e-45,
                         65504.0, -0.0],
                        rng.standard_normal(100_000) * 0.02,
                        rng.standard_normal(1000) * 1e4])
    got = frontends.bf16_from_numpy(x)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jnp.asarray(x, jnp.bfloat16)))
    assert float(got[0]) == 1.0


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", FRONTEND_ARCHS + ["arctic-480b"])
def test_synth_batch_bit_for_bit(arch, kind):
    jcfg, cfg = jax_reduced(jax_get_arch(arch)), reduced(get_arch(arch))
    for B, S, seed in ((2, 16, 3), (1, 33, 0)):
        want = jax_frontends.synth_batch(jcfg, B, S, seed=seed, kind=kind)
        got = frontends.synth_batch(cfg, B, S, seed=seed, kind=kind)
        _same_batch(got, want)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_batch_specs_match_jax(arch):
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    for fn in ("train_batch_spec", "prefill_batch_spec"):
        want = getattr(jax_frontends, fn)(jcfg, 4, 1500)
        got = getattr(frontends, fn)(cfg, 4, 1500)
        assert list(got) == list(want)
        for name, (shape, dtype) in want.items():
            assert got[name][0] == shape
            assert str(got[name][1]).split(".")[-1] == jnp.dtype(dtype).name


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_synthetic_lm_frontend_batches_bit_for_bit(arch):
    """SyntheticLM's vision-stub batch (embeds, M-RoPE positions, no
    tokens) and audio-stub batch (audio_embeds beside the tokens), at
    several steps and shards, equal the reference's."""
    jcfg, cfg = jax_reduced(jax_get_arch(arch)), reduced(get_arch(arch))
    for step, shard, shards in ((0, 0, 1), (3, 1, 2), (7, 0, 2)):
        want = JaxSyntheticLM(jcfg, 4, 24, seed=5).batch_at(
            step, shard=shard, num_shards=shards)
        got = SyntheticLM(cfg, 4, 24, seed=5, device="cpu").batch_at(
            step, shard=shard, num_shards=shards)
        _same_batch(got, want)


def _grid(B, t, h, w, seed):
    """(B, 3, t*h*w) M-RoPE positions of a t x h x w patch grid after a
    few text tokens, each row shifted: the three streams differ."""
    tt, hh, ww = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                             indexing="ij")
    grid = np.stack([tt.ravel(), hh.ravel(), ww.ravel()])
    shift = np.random.default_rng(seed).integers(0, 50, (B, 1, 1))
    return (grid[None] + shift).astype(np.int32)


@pytest.mark.parametrize("head_dim", [128, 32, 16])
def test_apply_mrope_matches_jax(head_dim):
    """Full sections (16, 24, 24) at head dim 128; the reduced-sections
    branch at 32 and 16; a (t, h, w) grid, and text positions broadcast
    from one row as the decode and chunk paths pass them."""
    rng = np.random.default_rng(head_dim)
    B, H = 2, 3
    pos = _grid(B, 2, 3, 4, head_dim)
    x = rng.standard_normal((B, pos.shape[-1], H, head_dim)).astype(
        np.float32)
    want = jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    text = np.broadcast_to(np.arange(24)[None, None], (1, 3, 24)).astype(
        np.int32)
    want = jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(text), 1e6)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(text),
                             1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    half = head_dim // 2
    assert sum(layers.mrope_sections(half)) == half
    assert (layers.mrope_sections(half) == layers.MROPE_SECTIONS) == \
        (head_dim == 128)


def test_mrope_text_positions_equal_rope():
    """With all three streams equal (text tokens) M-RoPE is RoPE."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 9, 2, 128)).astype(
        np.float32))
    pos = torch.arange(9)[None]
    np.testing.assert_allclose(
        layers.apply_mrope(x, pos[:, None].expand(1, 3, 9), 1e6).numpy(),
        layers.apply_rope(x, pos, 1e6).numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("seq,d", [(1500, 1280), (37, 128)])
def test_sinusoidal_positions_match_jax(seq, d):
    np.testing.assert_array_equal(layers.sinusoidal_positions(seq, d),
                                  np.asarray(jax_layers.sinusoidal_positions(
                                      seq, d)))


def test_sinusoidal_at_matches_the_table():
    """The decode path's closed form at run-time positions against the
    table of the prefill path (computed in float64 and rounded once)."""
    table = layers.sinusoidal_positions(64, 128)
    for pos in (0, 17, torch.tensor([3, 40, 63])):
        got = layers.sinusoidal_at(pos, 128, "cpu").numpy()
        idx = np.atleast_1d(np.asarray(pos))
        np.testing.assert_allclose(got, table[idx], atol=2e-5, rtol=0)
