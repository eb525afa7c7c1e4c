"""The bloom up chain's CPU route (shade/bloom.py bloom_up_chain on a CPU
tensor: its plain version, bloom_up_chain_plain) against the JAX package on
the CPU, its checks, and the level table of its launch.

  - bloom_up_chain(deepest, h, w, passes, strength, base, exposure, rows)
    against JAX's upsample_tent9 chain (each level on JAX's own previous
    level, the last at the strength, added to base) and
    gamma_encode(aces_approx(exposure * ...)), on the chains of
    tests/test_torch_post.py (96x160 and 64x64 are 2x throughout, 135x240
    and 54x96 meet odd sizes), whole and over a row window of the last
    level, within 1e-5 (f32 in both; the odd levels' linear resize sums its
    weights in another order than XLA);
  - on a CPU tensor it is bloom_up_chain_plain bit for bit, and the same as
    per-level bloom_up_level calls, with no launch counted;
  - its checks (ValueError) on what the kernel does not take;
  - the level table of the launch (shade/bloom.py up_chain_levels) for the
    1920x1088 and 1920x1080 frames: sizes in launch order, which levels take
    the linear resize, each intermediate level on a 128-byte line of the
    chain buffer and the last level's row window.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 3d).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.shade import bloom as jbloom
from vulkan_pbr_renderer_tpu.utils import color as jcolor
from vulkan_pbr_renderer_tpu_torch.shade import bloom as tbloom

CHAINS = [((96, 160), 3), ((135, 240), 4), ((54, 96), 3), ((64, 64), 6)]
CHAIN_IDS = [f"{s[0]}x{s[1]}" for s, _ in CHAINS]
STRENGTH, EXPOSURE = 0.06, 1.2


def _rand(shape, seed):
    return np.random.default_rng(seed).uniform(0, 3, shape + (3,)).astype(np.float32)


@functools.cache
def _jax_up():
    return jax.jit(jbloom.upsample_tent9, static_argnums=(1, 2, 3))


def _jax_chain(deepest, h, w, passes):
    """JAX's up chain (bloom_with_pyramid's) from deepest: the last level's
    tent at STRENGTH, not yet added to anything."""
    sizes = tbloom.chain_sizes(h, w, passes)
    cur = jnp.asarray(deepest)
    for i in range(passes - 1, 0, -1):
        cur = _jax_up()(cur, *sizes[i], 1.0)
    return np.asarray(_jax_up()(cur, h, w, STRENGTH))


@pytest.mark.parametrize("window", [None, "rows"], ids=["whole", "rows"])
@pytest.mark.parametrize("shape,passes", CHAINS, ids=CHAIN_IDS)
def test_up_chain_plain_matches_jax(shape, passes, window):
    h, w = shape
    sizes = tbloom.chain_sizes(h, w, passes)
    deepest = _rand(sizes[passes], 11)
    rb, rc = (h // 3 | 1, h // 3) if window else (0, h)
    base = _rand((rc, w), 12)
    got = tbloom.bloom_up_chain(torch.from_numpy(deepest), h, w, passes, STRENGTH,
                                torch.from_numpy(base), EXPOSURE,
                                rows=(rb, rc) if window else None)
    tent = _jax_chain(deepest, h, w, passes)[rb:rb + rc]
    want = jcolor.gamma_encode(jcolor.aces_approx(EXPOSURE * (jnp.asarray(base) + tent)))
    assert tuple(got.shape) == (rc, w, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,passes", [((54, 96), 3), ((64, 64), 1)], ids=["54x96", "1"])
def test_up_chain_cpu_takes_plain(shape, passes):
    """On CPU tensors: bloom_up_chain_plain bit for bit, the same as the
    per-level calls, without the tonemap too; no launch counted."""
    h, w = shape
    sizes = tbloom.chain_sizes(h, w, passes)
    deepest = torch.from_numpy(_rand(sizes[passes], 13))
    base = torch.from_numpy(_rand((h, w), 14))
    counts = (tbloom.bloom_up_chain.launches, tbloom.bloom_up_level.launches)
    for e in (EXPOSURE, None):
        got = tbloom.bloom_up_chain(deepest, h, w, passes, STRENGTH, base, e)
        want = tbloom.bloom_up_chain_plain(deepest, h, w, passes, STRENGTH, base, e)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        cur = deepest
        for i in range(passes - 1, 0, -1):
            cur = tbloom.bloom_up_level(cur, *sizes[i], 1.0)
        levels = tbloom.bloom_up_level(cur, h, w, STRENGTH, base=base, exposure=e)
        np.testing.assert_array_equal(got.numpy(), levels.numpy())
    assert (tbloom.bloom_up_chain.launches, tbloom.bloom_up_level.launches) == counts


def test_up_chain_rejects_bad_inputs():
    deepest = torch.from_numpy(_rand((8, 12), 15))
    base = torch.from_numpy(_rand((64, 96), 16))
    with pytest.raises(ValueError, match="float32"):
        tbloom.bloom_up_chain(deepest.double(), 64, 96, 3, STRENGTH, base)
    with pytest.raises(ValueError, match=r"\[h, w, 3\]"):
        tbloom.bloom_up_chain(deepest[..., :2], 64, 96, 3, STRENGTH, base)
    with pytest.raises(ValueError, match="shape"):
        tbloom.bloom_up_chain(deepest, 64, 96, 2, STRENGTH, base)
    with pytest.raises(ValueError, match="base"):
        tbloom.bloom_up_chain(deepest, 64, 96, 3, STRENGTH, base[:40])
    with pytest.raises(ValueError, match="base"):
        tbloom.bloom_up_chain(deepest, 64, 96, 3, STRENGTH, None)
    with pytest.raises(ValueError, match="rows"):
        tbloom.bloom_up_chain(deepest, 64, 96, 3, STRENGTH, base[:8], rows=(60, 8))
    with pytest.raises(ValueError, match="passes"):
        tbloom.bloom_up_chain(deepest, 64, 96, 0, STRENGTH, base)
    with pytest.raises(ValueError, match="passes"):
        tbloom.bloom_up_chain(deepest, 64, 96, tbloom.MAX_CHAIN_LEVELS + 1, STRENGTH, base)


@pytest.mark.parametrize("h,rows", [(1088, None), (1080, None), (1080, (541, 539))],
                         ids=["1088", "1080", "1080_rows"])
def test_up_chain_level_table(h, rows):
    """The launch's levels, built without a launch: deepest first, the
    linear resize only where a level is not exactly 2x (1080 rows: 16 -> 33
    -> 67 -> 135), each intermediate level whole and on a 128-byte line
    right after the one before it, the last level's rows the window."""
    levels, floats = tbloom.up_chain_levels(h, 1920, 6, rows)
    sizes = tbloom.chain_sizes(h, 1920, 6)
    assert [(lv.src, lv.dst) for lv in levels] == [(sizes[i + 1], sizes[i])
                                                    for i in range(5, -1, -1)]
    assert [lv.up2 for lv in levels] == ([True] * 6 if h == 1088
                                         else [False, False, False, True, True, True])
    off = 0
    for lv in levels[:-1]:
        assert lv.out_off == off and lv.out_off % 32 == 0
        assert lv.rows == (0, lv.dst[0])
        off += -(-3 * lv.dst[0] * lv.dst[1] // 32) * 32
    assert floats == off
    assert levels[-1].rows == (rows if rows else (0, h)) and levels[-1].out_off == 0
