"""The lightgrid sweep's ring kernel (csrc/sweep.cu sweep_ring_kernel) on
the CPU: its walk over a grid's lines and its scan in registers, each
modelled in numpy.

- The walk (_ring_walk: sweep_ring_kernel's group and stage order): every
  voxel of every line is loaded, swept and stored exactly once on every
  axis of the seeded shapes, with any number of persistent blocks; a
  stage is loaded again only after the stores of its last group read it,
  at most its stages' groups are in a block's ring at once, and for the
  z and y axes of a grid whose x is a multiple of 8 each step of a group is
  one 128-byte line of device memory.
- The scan: a line lies in L lanes (csrc/sweep.cu kLanes, 16: two lines a
  warp; the sweep-only sweep_variants.cu's 32: one) of K adjacent voxels
  each, a combine inside a lane
  in registers, one across lanes from a shuffle of the source lane's last
  voxel (scan_level's predicates, the backward sweep with lanes and slots
  mirrored).  The model's combines are sweep_schedule's pairs, level by
  level, and its results are _linrec_scan's bits on every length the
  kernel takes (L * 1, 2, 4, 8, 16), forward and backward.  Tolerance:
  none (f32 bits).

No jax: the references are the port's own plain versions, which
test_torch_sweep_kernel.py holds to JAX.
"""

import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu_torch.shade import gi

# the seeded shapes of tests/test_torch_cuda.py and chip_smoke.py phase 3f
# that the ring kernel takes on at least one axis, and a grid whose lines
# do not fill a group
SHAPES = [("jax32", (32, 4, 4)), ("cube16", (16, 16, 16)), ("cube128", (128, 128, 128)),
          ("ragged64", (64, 3, 5)), ("line256", (2, 3, 256))]
LENGTHS = [(lanes, lanes * k) for lanes in (16, 32) for k in (1, 2, 4, 8, 16)]


RING_LINES = 8   # csrc/sweep.cu kRingLines: lines a group
STAGES = 2       # csrc/sweep.cu kStages: the ring's stages
LANES = 16       # csrc/sweep.cu kLanes: lanes a line


def _ring_k(n, lanes=LANES):
    """The voxels K a lane holds in the ring kernel for lines of n voxels (n
    = lanes * K, K 1, 2, 4, 8 or 16; csrc/sweep.cu ring_k), or 0 where the
    replay kernel takes the length."""
    k = n // lanes
    return k if n % lanes == 0 and k in (1, 2, 4, 8, 16) else 0


def _ring_axes(shape):
    return [a for a in range(3) if _ring_k(shape[a])]


def _ring_walk(shape, axis, blocks, stages=STAGES):
    """sweep_ring_kernel's work in the order a block runs it: {block:
    [(step, group, stage, voxels)]}, step "load" (the group's copies into
    the stage), "sweep" (its lanes' scans there) or "store" (the stage to
    the grid and the table), voxels an int64 [lines, n] array of the
    group's voxel offsets (gi.sweep_layout's addresses).  Block b takes
    groups b, b + blocks, ... of RING_LINES lines (the last one short where
    the lines do not fill it), its k-th in stage k % stages; the copies of
    its group k + stages - 1 start once group k has landed and group k - 1's
    stores have read that stage."""
    n = shape[axis]
    lines, inner, outer, stride = gi.sweep_layout(shape, axis)
    groups = -(-lines // RING_LINES)

    def voxels(g):
        ls = np.arange(g * RING_LINES, min((g + 1) * RING_LINES, lines))
        return ((ls // inner) * outer + ls % inner)[:, None] + np.arange(n) * stride

    walk = {}
    for b in range(min(blocks, groups)):
        mine = list(range(b, groups, blocks))
        ev = [("load", g, s, voxels(g)) for s, g in enumerate(mine[:stages - 1])]
        for k, g in enumerate(mine):
            nxt = k + stages - 1
            if nxt < len(mine):
                ev.append(("load", mine[nxt], nxt % stages, voxels(mine[nxt])))
            ev += [("sweep", g, k % stages, voxels(g)), ("store", g, k % stages, voxels(g))]
        walk[b] = ev
    return walk


@pytest.mark.parametrize("blocks,stages", [(1, STAGES), (7, STAGES), (792, STAGES), (7, 3)])
@pytest.mark.parametrize("name,shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_ring_walk_covers_every_line_once(name, shape, blocks, stages):
    d, h, w = shape
    for axis in _ring_axes(shape):
        walk = _ring_walk(shape, axis, blocks, stages)
        seen = {step: np.zeros(d * h * w, np.int64) for step in ("load", "sweep", "store")}
        for events in walk.values():
            holds = {}   # stage -> the group loaded into it and not yet stored
            done = set()
            for step, group, stage, voxels in events:
                assert voxels.shape[1] == shape[axis]
                np.add.at(seen[step], voxels.ravel(), 1)
                if step == "load":
                    assert stage not in holds, f"{name} axis {axis}: stage {stage} reloaded"
                    holds[stage] = group
                    assert len(holds) <= stages
                elif step == "sweep":
                    assert holds.get(stage) == group, f"{name} axis {axis}: {group} not loaded"
                else:
                    assert holds.pop(stage) == group and group not in done
                    done.add(group)
            assert not holds
        for step, count in seen.items():
            assert (count == 1).all(), f"{name} axis {axis} {step}: {np.unique(count)}"
        if axis < 2 and w % 8 == 0:   # a step of 8 lines adjacent in x: one 128-byte line
            for events in walk.values():
                for _, _, _, voxels in events:
                    if len(voxels) == RING_LINES:
                        np.testing.assert_array_equal(np.diff(voxels, axis=0), 1)


def test_ring_lanes_and_layout():
    """The lengths the ring kernel takes (LANES K voxels, K = 1, 2, 4, 8, 16:
    16-256 voxels, every axis of the frame's 128^3 grid, as
    tests/test_torch_cuda.py::test_sweep_occupancy holds csrc/sweep.cu to on
    the card) and the line layout both kernels address (sweep_layout)."""
    assert [n for n in range(1, 600) if _ring_k(n)] == [16, 32, 64, 128, 256]
    assert [_ring_k(n, 32) for n in (32, 128, 512, 520)] == [1, 4, 16, 0]
    for shape in ((7, 9, 5), (128, 128, 128), (32, 4, 4)):
        d, h, w = shape
        ref = np.arange(d * h * w).reshape(d, h, w)
        for axis in range(3):
            lines, inner, outer, stride = gi.sweep_layout(shape, axis)
            line = np.arange(lines)
            got = ((line // inner) * outer + line % inner)[:, None] + np.arange(
                shape[axis]) * stride
            want = np.moveaxis(ref, axis, -1).reshape(lines, shape[axis])
            np.testing.assert_array_equal(got, want)


def _combine(src, dst):
    """(a1, b1) . (a2, b2) = (a1 * a2, a2 * b1 + b2) in f32, unfused."""
    (a1, b1), (a2, b2) = src, dst
    return a1 * a2, a2[..., None] * b1 + b2


def _model_scan(a, b, reverse, n_lanes, pairs=None):
    """csrc/sweep.cu's scan_regs in numpy over a line of n = n_lanes * K
    voxels: a [n] and b [n, 3] float32 in real positions; lane l of the
    line holds real positions l*K .. l*K + K - 1 in its slots.  Returns (A,
    B) and, if pairs is a list, appends each level's (src, dst) real
    positions."""
    n = len(a)
    k = _ring_k(n, n_lanes)
    lanes = np.arange(n_lanes)
    xa = a.reshape(n_lanes, k).copy()
    xb = b.reshape(n_lanes, k, 3).copy()
    lk = n_lanes - 1 - lanes if reverse else lanes
    levels = int(np.log2(n))

    def phys(j):   # the physical slot of scan slot j
        return k - 1 - j if reverse else j

    def level(d, up):
        s = 1 << d
        last = phys(k - 1)
        delta = s // k if s >= k else 1
        # the shuffle: scan slot k-1 of the lane `delta` scan lanes before
        # (a lane past the line's edge keeps its own, as __shfl_*_sync does
        # within its width)
        src_lane = lanes + delta if reverse else lanes - delta
        src_lane = np.where((src_lane >= 0) & (src_lane < n_lanes), src_lane, lanes)
        nb_a, nb_b = xa[src_lane, last], xb[src_lane, last]
        na, nb = xa.copy(), xb.copy()
        got = []
        for j in range(k - 1 if s >= k else 0, k):
            p1 = lk * k + j + 1
            dst = (p1 & (2 * s - 1)) == 0 if up else ((p1 & (2 * s - 1)) == s) & (p1 > s)
            if j >= s:
                sa, sb = xa[:, phys(j - s)], xb[:, phys(j - s)]
            else:
                sa, sb = nb_a, nb_b
            ca, cb = _combine((sa, sb), (xa[:, phys(j)], xb[:, phys(j)]))
            na[:, phys(j)] = np.where(dst, ca, xa[:, phys(j)])
            nb[:, phys(j)] = np.where(dst[:, None], cb, xb[:, phys(j)])
            real_dst = lanes * k + phys(j)
            real_src = real_dst + s if reverse else real_dst - s
            got += [(int(sr), int(dr)) for sr, dr, m in zip(real_src, real_dst, dst) if m]
        xa[:], xb[:] = na, nb
        if pairs is not None and got:
            pairs.append(sorted(got, key=lambda p: p[1]))

    for d in range(levels):
        level(d, True)
    for d in range(levels - 2, -1, -1):
        level(d, False)
    return xa.reshape(n), xb.reshape(n, 3)


@pytest.mark.parametrize("lanes,n", LENGTHS)
def test_register_scan_pairs_are_the_schedule(lanes, n):
    """The model's combines, level by level, are sweep_schedule(n)'s pairs
    (forward); backward they are the same pairs mirrored."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0, 1, n).astype(np.float32)
    b = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    want = [sorted(map(tuple, lv.tolist()), key=lambda p: p[1]) for lv in gi.sweep_schedule(n)]
    fwd, bwd = [], []
    _model_scan(a, b, False, lanes, fwd)
    _model_scan(a, b, True, lanes, bwd)
    assert fwd == want
    mirrored = [sorted(((n - 1 - s, n - 1 - d) for s, d in lv), key=lambda p: p[1])
                for lv in want]
    assert bwd == mirrored


@pytest.mark.parametrize("occupied", [0.0, 0.3, 1.0], ids=["empty", "30pct", "full"])
@pytest.mark.parametrize("lanes,n", LENGTHS)
def test_register_scan_matches_linrec_bits(lanes, n, occupied):
    """The model's (A, B) equal _linrec_scan's bits, forward and backward
    (the plain version flips the line for the backward sweep), on lines
    whose a is move_ratio or 0 (occupied) as the sweep makes them, and on
    random a (products reach denormals on empty lines)."""
    rng = np.random.default_rng(1000 * n + int(10 * occupied))
    occ = rng.random(n) < occupied
    for a in (np.where(occ, 0.0, 0.5).astype(np.float32),
              rng.uniform(0, 1, n).astype(np.float32)):
        b = rng.uniform(0, 3, (n, 3)).astype(np.float32)
        for reverse in (False, True):
            ta, tb = torch.from_numpy(a)[:, None], torch.from_numpy(b)
            if reverse:
                ta, tb = ta.flip(0), tb.flip(0)
            want_a, want_b = gi._linrec_scan(ta, tb)
            if reverse:
                want_a, want_b = want_a.flip(0), want_b.flip(0)
            got_a, got_b = _model_scan(a, b, reverse, lanes)
            np.testing.assert_array_equal(got_a.view(np.int32),
                                          want_a[:, 0].numpy().view(np.int32))
            np.testing.assert_array_equal(got_b.view(np.int32), want_b.numpy().view(np.int32))
