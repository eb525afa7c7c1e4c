"""The reference-GI ray kernel's queue on the CPU (shade/gi.py): the
lanes a block's queue hands its warps (gi.compact_tiles, the order
csrc/gi_reference_ray.cu's queue takes when its warps append in tile
order) and the per-phase SIMT efficiency of the first design (each lane
in its warp tile, three taps a crossing) and of the kernel (its march
queue, the taps the outcome needs: gi.reference_simt), and of the queue
designs reference_sweep.py models (reference_sweep.queue_simt), held
against a direct count over the plain version's per-lane step counts.
The kernel itself runs on the card: tests/test_torch_cuda.py and
chip_smoke.py.  Integer counts, compared exactly.
"""

import numpy as np
import pytest
import torch

import reference_sweep
from test_torch_reference_ray_inputs import _one_thread, set_call_args  # noqa: F401
from vulkan_pbr_renderer_tpu_torch.shade import gi


def _queue_direct(mask, tiles, block_tiles):
    """A block queue's warps counted lane by lane: each block's lanes in
    tile then slot order, those where mask holds, in runs of 32."""
    warps = []
    tiles = tiles.tolist()
    for b in range(0, len(tiles), block_tiles):
        run = [i for t in tiles[b:b + block_tiles] for i in t if i >= 0 and mask[i]]
        warps += [run[k:k + 32] for k in range(0, len(run), 32)]
    return warps


def _issued_direct(counts, warps):
    """(steps done, slots issued): each warp runs to its longest lane."""
    done = sum(counts[i] for w in warps for i in w)
    return done, sum(32 * max(counts[i] for i in w) for w in warps)


def _simt_direct(work, tiles, block_tiles=None, split=0):
    tile_lanes = [[i for i in t if i >= 0] for t in tiles.tolist()]
    tile_lanes = [t for t in tile_lanes if t]
    out, done, issued = {}, 0, 0
    for kind in gi.REF_PHASES:
        c = work[kind].tolist()
        if kind == "taps" and block_tiles is None:   # the first design: three a crossing
            c = [3 * x for x in work["crossing"].tolist()]
        if kind == "march" and block_tiles:
            seed = work["seed"].tolist()
            d, i = _issued_direct(c, _queue_direct([s > 0 for s in seed], tiles, block_tiles))
        elif kind == "trace" and block_tiles and split:
            first = [min(x, split) for x in c]
            rest = [x - f for x, f in zip(c, first)]
            d1, i1 = _issued_direct(first, tile_lanes)
            d2, i2 = _issued_direct(rest, _queue_direct([x > split for x in c], tiles,
                                                        block_tiles))
            d, i = d1 + d2, i1 + i2
        else:
            d, i = _issued_direct(c, tile_lanes)
        out[kind] = d / i if i else 1.0
        done, issued = done + d, issued + i
    out["all"] = done / issued if issued else 1.0
    return out


@pytest.mark.parametrize("rows,width,block_tiles", [(24, 40, 4), (7, 143, 4), (1, 70, 3),
                                                    (9, 33, 8), (2, 5, 1)])
def test_compact_tiles_is_the_queue_order(rows, width, block_tiles):
    """Every masked lane in exactly one warp, in its block's tile then slot
    order, 32 a warp but each block's last; no unmasked lane."""
    tiles = gi.lane_tiles(rows, width, gi.lane_tile_h(rows))
    mask = torch.from_numpy(np.random.default_rng(rows * width).random(rows * width) < 0.6)
    got = gi.compact_tiles(mask, tiles, block_tiles)
    want = _queue_direct(mask.tolist(), tiles, block_tiles)
    assert got.shape == (len(want), 32)
    assert [[i for i in w if i >= 0] for w in got.tolist()] == want
    assert sorted(i for w in want for i in w) == torch.nonzero(mask).reshape(-1).tolist()


def test_compact_tiles_of_no_lane():
    tiles = gi.lane_tiles(4, 8, 4)
    assert gi.compact_tiles(torch.zeros(32, dtype=torch.bool), tiles, 4).shape == (0, 32)


@pytest.fixture(scope="module")
def seeded_work():
    """The plain version's per-lane counts on two seeded sets, their lanes
    laid out as a [32, 64] grid."""
    out = {}
    for name in ("diffuse", "dense"):
        work = {}
        gi.reference_ray_resolve_plain(*set_call_args(name, "cpu"), work=work)
        out[name] = work
    return out


@pytest.mark.parametrize("name", ["diffuse", "dense"])
@pytest.mark.parametrize("block_tiles,split", [(None, 0), (4, 0), (4, 8), (8, 6), (3, 2)],
                         ids=lambda v: str(v))
def test_reference_simt_counts(seeded_work, name, block_tiles, split):
    """The SIMT models against the direct count, per phase and all
    together, in 8 x 4 tiles of a [32, 64] grid: gi.reference_simt for the
    first design and the kernel (a block of gi.REF_BLOCK_TILES tiles, no
    trace split), reference_sweep.queue_simt for the other queue designs
    (and the kernel's, where they meet)."""
    work = seeded_work[name]
    tiles = gi.lane_tiles(32, 64, 8)
    want = _simt_direct(work, tiles, block_tiles, split)
    if block_tiles is None:
        got = gi.reference_simt(work, tiles)
    else:
        got = reference_sweep.queue_simt(work, tiles, block_tiles, split)
        if (block_tiles, split) == (gi.REF_BLOCK_TILES, 0):
            assert gi.reference_simt(work, tiles, queue=True) == got
    assert got.keys() == want.keys() == set(gi.REF_PHASES) | {"all"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_reference_simt_of_the_first_design_is_per_phase(seeded_work):
    """Without the queue each phase is gi.simt_efficiency of its counts
    alone, the taps three a crossing."""
    work = seeded_work["diffuse"]
    tiles = gi.lane_tiles(32, 64, 8)
    got = gi.reference_simt(work, tiles)
    for kind in gi.REF_PHASES:
        counts = 3 * work["crossing"] if kind == "taps" else work[kind]
        assert got[kind] == pytest.approx(gi.simt_efficiency({kind: counts}, tiles))


def test_reference_simt_queues_fill_the_march(seeded_work):
    """The march queue runs the marching lanes of a block in full warps: its
    issued slots are at most its tiles', the trace's split keeps every
    step, and equal lanes run at 1.0 in either design."""
    work = seeded_work["dense"]
    tiles = gi.lane_tiles(32, 64, 8)
    before = gi.reference_simt(work, tiles)
    after = gi.reference_simt(work, tiles, queue=True)
    split = reference_sweep.queue_simt(work, tiles, 4, 8)
    assert after["march"] >= before["march"] and after["skip"] == before["skip"]
    assert split["march"] == after["march"] and split["taps"] == after["taps"]
    steps = int(work["trace"].sum())
    first = torch.clamp(work["trace"], max=8)
    assert int(first.sum()) + int((work["trace"] - first).sum()) == steps
    ones = {k: torch.ones(2048, dtype=torch.int32) for k in gi.REF_PHASES + ("seed", "crossing")}
    ones["taps"] = 3 * ones["crossing"]
    assert all(v == 1.0 for v in gi.reference_simt(ones, tiles).values())
    assert all(v == 1.0 for v in gi.reference_simt(ones, tiles, queue=True).values())
    assert all(v == 1.0 for v in reference_sweep.queue_simt(ones, tiles, 4, 1).values())


def test_taps_are_the_outcomes(seeded_work):
    """The plain version counts the taps a crossing's outcome needs: two,
    and the third on some crossings but not all (the seeded sets have both
    kinds)."""
    for name, work in seeded_work.items():
        crossings, taps = int(work["crossing"].sum()), int(work["taps"].sum())
        assert 2 * crossings < taps < 3 * crossings, name
        assert bool(((2 * work["crossing"] <= work["taps"])
                     & (work["taps"] <= 3 * work["crossing"])).all()), name
