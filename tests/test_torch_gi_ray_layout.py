"""The fast-GI ray kernel's lane order on the CPU (shade/gi.py): the warp
tiles the kernel csrc/gi_fast_ray.cu takes its lanes in (gi.lane_grid,
gi.lane_tile_h, gi.lane_tiles, mirrored by the kernel's tile_lane), the
per-lane step counts of the plain version (its `work`) and the SIMT
efficiency of a lane order (gi.simt_efficiency), held against a direct
count.  The kernel itself runs on the card: tests/test_torch_cuda.py and
chip_smoke.py.  Integer results, compared exactly.
"""

import numpy as np
import pytest
import torch

from test_torch_gi_ray_inputs import random_rays, ray_call_args
from vulkan_pbr_renderer_tpu_torch.shade import gi


@pytest.mark.parametrize("shape,rows,width,tile_h", [
    ((7, 143), 7, 143, 4), ((1, 1), 1, 1, 1), ((3, 1000), 3, 1000, 2), ((1001,), 1, 1001, 1),
    ((1,), 1, 1, 1), ((0,), 0, 0, 1), ((544, 480), 544, 480, 8), ((2, 5, 33), 10, 33, 8)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else None)
def test_lane_tiles_are_a_permutation(shape, rows, width, tile_h):
    """Every lane of a ragged grid lies in exactly one slot of one warp tile;
    a tile is tile_h rows of 32 // tile_h neighbouring lanes."""
    assert gi.lane_grid(shape) == (rows, width)
    assert gi.lane_tile_h(rows) == tile_h
    tiles = gi.lane_tiles(rows, width, tile_h)
    n = int(np.prod(shape))
    assert tiles.shape[1] == 32
    valid = tiles[tiles >= 0]
    assert sorted(valid.tolist()) == list(range(n))
    tw = 32 // tile_h
    assert tiles.shape[0] == -(-width // tw) * -(-rows // tile_h) if n else tiles.shape[0] == 0
    for t in tiles[:3].tolist() + tiles[-2:].tolist():
        cells = [(i // width, i % width) for i in t if i >= 0]
        r0, c0 = min(cells)
        assert all(0 <= r - r0 < tile_h and 0 <= c - c0 < tw for r, c in cells)


def test_lane_tiles_of_rows_are_row_order():
    """One-row tiles are the flat order in runs of 32, padded at each row's
    end."""
    tiles = gi.lane_tiles(3, 70, 1)
    assert tiles.shape == (9, 32)
    assert tiles[0].tolist() == list(range(32))
    assert tiles[2].tolist() == list(range(64, 70)) + [-1] * 26
    assert tiles[3].tolist() == list(range(70, 102))


def _simt_direct(counts, tiles):
    """The efficiency counted lane by lane: each kind's loop runs until the
    tile's longest lane is done, on 32 slots."""
    issued = useful = 0
    for t in tiles:
        lanes = [i for i in t if i >= 0]
        for c in counts:
            issued += 32 * max(c[i] for i in lanes)
            useful += sum(c[i] for i in lanes)
    return useful / issued


@pytest.mark.parametrize("spec", [False, True], ids=["diffuse", "specular"])
def test_simt_efficiency_of_seed_made_lanes(spec):
    """The plain version's per-lane counts stay within each loop's budget
    and leave its result as it was, and simt_efficiency equals the direct
    count for rows and for 8-row tiles."""
    arrays, scalars = random_rays(30 + spec, n=24 * 40)
    args = list(ray_call_args(arrays, scalars, "cpu", spec=spec))
    for i in (8, 9, 10):
        args[i] = args[i].reshape(24, 40, 3)
    for i in (11, 12):
        if torch.is_tensor(args[i]):
            args[i] = args[i].reshape(24, 40)
    lane_work = {}
    rgb_a, st_a = gi.fast_ray_resolve_plain(*args, work=lane_work)
    rgb_b, st_b = gi.fast_ray_resolve_plain(*args)
    torch.testing.assert_close(rgb_a, rgb_b, rtol=0, atol=0)
    torch.testing.assert_close(st_a, st_b, rtol=0, atol=0)
    rp = args[13]
    budget = {"skip": rp.skip_steps, "march": rp.march_steps,
              "trace": rp.trace_steps + (rp.trace_rounds - 1) * rp.trace_steps2,
              "taps": rp.trace_rounds * rp.solid_taps, "fallback": 1, "resolve": 1}
    assert set(lane_work) == set(budget)
    for k, v in lane_work.items():
        assert v.shape == (24, 40) and v.dtype == torch.int32
        assert 0 <= int(v.min()) and int(v.max()) <= budget[k] and int(v.sum()) > 0, k
    torch.testing.assert_close(lane_work["fallback"], (st_a == 1).to(torch.int32))
    torch.testing.assert_close(lane_work["resolve"], (st_a == 3).to(torch.int32))
    counts = [lane_work[k].reshape(-1).tolist() for k in ("skip", "march", "trace", "taps")]
    for tile_h in (1, 8):
        tiles = gi.lane_tiles(24, 40, tile_h)
        got = gi.simt_efficiency(lane_work, tiles)
        assert got == pytest.approx(_simt_direct(counts, tiles.tolist()), rel=1e-12)
        assert 0.0 < got < 1.0


def test_simt_efficiency_of_equal_lanes_is_one():
    ones = {"skip": torch.full((4, 8), 2, dtype=torch.int32),
            "march": torch.full((4, 8), 5, dtype=torch.int32)}
    assert gi.simt_efficiency(ones, gi.lane_tiles(4, 8, 4)) == 1.0
    # a ragged tile leaves slots empty
    assert gi.simt_efficiency(ones, gi.lane_tiles(4, 8, 1)) == 0.25


def test_wrapper_rejects_too_many_pyramid_levels():
    """The kernel keeps the offsets of at most gi.MAX_LEVELS pyramid levels."""
    arrays, scalars = random_rays(8, n=64)
    args = list(ray_call_args(arrays, scalars, "cpu"))
    args[13] = args[13]._replace(prev_levels=gi.MAX_LEVELS + 1)
    with pytest.raises(ValueError, match="levels"):
        gi.fast_ray_resolve(*args)
