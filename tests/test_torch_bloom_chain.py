"""The bloom down chain's CPU route (shade/bloom.py bloom_down_chain on a CPU
tensor: its plain version, bloom_down_chain_plain) against the JAX package
on the CPU, and against per-level bloom_down_level calls.

  - bloom_down_chain(hdr, passes, atlas, offsets) against JAX's
    downsample_13tap chain (each level on JAX's own previous level, level 1
    with the firefly clamp) and pack_mip_atlas(...).astype(bfloat16), on a
    chain that is 2:1 throughout (64x96, 5 passes) and one that meets odd
    sizes (68x120 -> 34x60 -> 17x30 -> 8x15 -> 4x7): each level within 1e-5
    (f32 in both; the odd levels' linear resize sums its weights in another
    order than XLA, ~1e-7), the atlas, its zero rows included, within one
    bf16 step (2^-7 relative: an f32 texel an ulp off may round the other
    way);
  - the chain's levels and atlas bit for bit those of per-level
    bloom_down_level calls (the row-sharded frame's route), with and
    without an atlas, with no launch counted on the CPU;
  - its checks (ValueError) on what the kernel does not take.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 3d).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.gpu import sampling as jsamp
from vulkan_pbr_renderer_tpu.shade import bloom as jbloom
from vulkan_pbr_renderer_tpu_torch.shade import bloom as tbloom

CHAINS = [((64, 96), 5), ((68, 120), 4)]
CHAIN_IDS = ["64x96_exact", "68x120_odd"]


def _hdr(shape, seed=8):
    return np.random.default_rng(seed).uniform(0, 3, shape + (3,)).astype(np.float32)


@functools.cache
def _jax_down():
    return jax.jit(jbloom.downsample_13tap, static_argnums=(1, 2, 3))


def _bits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("shape,passes", CHAINS, ids=CHAIN_IDS)
def test_chain_plain_matches_jax(shape, passes):
    hdr = _hdr(shape)
    sizes = tbloom.chain_sizes(*shape, passes)
    atlas, offs = tbloom.new_atlas(*shape, passes, "cpu")
    atlas.fill_(7.0)       # every texel of the bands is written, zeros included
    got = tbloom.bloom_down_chain(torch.from_numpy(hdr), passes, atlas, offs)
    assert [tuple(t.shape) for t in got] == [s + (3,) for s in sizes[1:]]
    cur, want = jnp.asarray(hdr), []
    for i in range(1, passes + 1):
        cur = _jax_down()(cur, *sizes[i], i == 1)
        want.append(cur)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    jatlas = jsamp.pack_mip_atlas(want).astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_allclose(atlas.float().numpy(), np.asarray(jatlas), rtol=2.0 ** -7,
                               atol=1e-5)
    for (lh, lw), col in zip(sizes[1:], offs):    # the zero rows below each level
        assert not atlas[lh:, col:col + lw].float().any()


@pytest.mark.parametrize("with_atlas", [True, False], ids=["atlas", "no_atlas"])
@pytest.mark.parametrize("shape,passes", CHAINS, ids=CHAIN_IDS)
def test_chain_equals_level_calls(shape, passes, with_atlas):
    hdr = torch.from_numpy(_hdr(shape, 9))
    sizes = tbloom.chain_sizes(*shape, passes)
    atlas, offs = tbloom.new_atlas(*shape, passes, "cpu") if with_atlas else (None, None)
    counts = (tbloom.bloom_down_chain.launches, tbloom.bloom_down_level.launches)
    got = tbloom.bloom_down_chain(hdr, passes, atlas, offs)
    levels_atlas = None if atlas is None else torch.full_like(atlas, 7.0)
    cur = hdr
    for i in range(1, passes + 1):
        cur = tbloom.bloom_down_level(cur, *sizes[i], i == 1, atlas=levels_atlas,
                                      atlas_col=offs[i - 1] if with_atlas else 0)
        np.testing.assert_array_equal(got[i - 1].numpy(), cur.numpy())
    if with_atlas:
        np.testing.assert_array_equal(_bits(atlas), _bits(levels_atlas))
    assert (tbloom.bloom_down_chain.launches, tbloom.bloom_down_level.launches) == counts


def test_chain_rejects_bad_inputs():
    hdr = torch.from_numpy(_hdr((32, 48)))
    atlas, offs = tbloom.new_atlas(32, 48, 3, "cpu")
    with pytest.raises(ValueError, match="float32"):
        tbloom.bloom_down_chain(hdr.double(), 3)
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        tbloom.bloom_down_chain(hdr[..., :2], 3)
    with pytest.raises(ValueError, match="bfloat16"):
        tbloom.bloom_down_chain(hdr, 3, atlas.float(), offs)
    with pytest.raises(ValueError, match="does not fit"):
        tbloom.bloom_down_chain(hdr, 3, atlas[:, :20].contiguous(), offs)
    with pytest.raises(ValueError, match="offsets"):
        tbloom.bloom_down_chain(hdr, 3, atlas)
    with pytest.raises(ValueError, match="passes"):
        tbloom.bloom_down_chain(hdr, tbloom.MAX_CHAIN_LEVELS + 1)
    assert tbloom.bloom_down_chain(hdr, 0) == []
