"""Voxelize (shade/gi.py voxelize_scene, decode_voxel_grid; on the card
csrc/voxelize.cu) on the CPU: its plain version, whole and through the
wrapper (which makes the per-scene plan gi._VoxelPlan where its caller
passes none), against the JAX package's voxelize_scene and
decode_voxel_grid, and the kernel's lookup of each sample's triangle
against the plain version's fills.

On the seeded sets of tests/test_torch_voxelize_inputs.py (no jax, no
torch; chip_smoke.py and test_torch_cuda.py use them too): large planes of
hundreds of samples a triangle, one-sample and zero-area triangles,
samples outside the grid, emissive materials, sun texels past the map's
edges, a stream cut below the true total and one above it, a texture lod
between levels.  Tolerance: none: words as int64, decoded grids as f32
bits.  The JAX side runs op by op (as test_torch_gi.py's voxelize test),
once a set (functools.cache); every set has the same shapes, so its
compiled ops serve them all.

The kernel runs only on the card (test_torch_cuda.py, chip_smoke.py);
here a numpy model of its lookup (each sample's binary search over the
plan's int32 offsets) is held to the plain version's scatter + cummax
fills, shards included.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_voxelize_inputs as vin
from vulkan_pbr_renderer_tpu.shade import gi as jgi
from vulkan_pbr_renderer_tpu_torch.shade import gi as tgi
from vulkan_pbr_renderer_tpu_torch.shade import shadow as tshadow


@functools.cache
def _atlas():
    return vin.atlas()


def _scene(s):
    """The port's scene of a set: fresh CPU tensors (tri_attr, mat_id) and
    the shared atlas."""
    packed, scale = _atlas()
    return types.SimpleNamespace(tri_attr=torch.from_numpy(s["tri_attr"].copy()),
                                 mat_id=torch.from_numpy(s["mat_id"].copy()),
                                 tex_packed=torch.from_numpy(packed),
                                 tex_scale=torch.from_numpy(scale))


@functools.cache
def _set(name):
    s = vin.SETS[name]()
    m, d = tshadow.sun_matrices(*s["sun"])
    s.update(sun_from_world=m.numpy(), sun_dir=d.numpy(), depth=vin.sun_depth())
    return s


def _args(s, total=vin.TOTAL, **kw):
    """voxelize_scene's arguments after the scene, as CPU tensors."""
    return ((vin.GRID, vin.SCALE, torch.from_numpy(s["depth"]),
             torch.from_numpy(s["sun_from_world"]), torch.from_numpy(s["sun_dir"]),
             torch.from_numpy(vin.EMISSION)),
            dict(total_samples=total, texture_lod=s["texture_lod"], **kw))


@functools.cache
def _jax(name):
    """JAX's packed words (int64) and decoded grid of a set, op by op."""
    s = _set(name)
    packed, scale = _atlas()
    scene = types.SimpleNamespace(tri_attr=jnp.asarray(s["tri_attr"]),
                                  mat_id=jnp.asarray(s["mat_id"]),
                                  tex_packed=jnp.asarray(packed), tex_scale=jnp.asarray(scale))
    words = jgi.voxelize_scene(scene, vin.GRID, vin.SCALE, jnp.asarray(s["depth"]),
                               jnp.asarray(s["sun_from_world"]), jnp.asarray(s["sun_dir"]),
                               jnp.asarray(vin.EMISSION), total_samples=vin.TOTAL,
                               texture_lod=s["texture_lod"])
    return np.asarray(words).astype(np.int64), np.asarray(jgi.decode_voxel_grid(words))


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("name", vin.NAMES)
def test_plan_route_matches_jax(name):
    """The wrapper's CPU route (the plain version, behind the plan's
    checks) and the plain version alone equal JAX's words and decoded grid
    bit for bit."""
    s = _set(name)
    scene = _scene(s)
    args, kw = _args(s)
    want_words, want_grid = _jax(name)
    got = tgi.voxelize_scene(scene, *args, **kw)
    assert got.dtype == torch.int64 and got.shape == (vin.GRID,) * 3
    np.testing.assert_array_equal(got.numpy(), want_words)
    np.testing.assert_array_equal(tgi.voxelize_scene_plain(scene, *args, **kw).numpy(),
                                  want_words)
    np.testing.assert_array_equal(_bits(tgi.decode_voxel_grid(got)), _bits(want_grid))
    assert int((got != 0).sum()) > 0
    total = int(vin.counts(s["tri_attr"]).sum())
    assert (total > vin.TOTAL) == (name == "cut")


def _model_lookup(offsets32, total, start, s_len, one_sample=False):
    """csrc/voxelize.cu's lookup (sample_triangle) in numpy: each sample pid
    of the slice [start, start + s_len) below the total takes the last
    triangle t with offsets[t] <= pid by the kernel's binary search over
    the int32 offsets, and local = pid - offsets[t]; on a one-sample stream
    t = pid and local = 0.  Returns (tri, local)."""
    tri, local = [], []
    for pid in range(start, min(start + s_len, total)):
        if one_sample:
            tri.append(pid)
            local.append(0)
            continue
        lo, hi = 0, len(offsets32) - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            lo, hi = (mid, hi) if offsets32[mid] <= pid else (lo, mid - 1)
        tri.append(lo)
        local.append(pid - offsets32[lo])
    return np.asarray(tri, np.int64), np.asarray(local, np.int64)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_kernel_lookup_matches_plain_fills(shards):
    """The model of the kernel's lookup gives the plain version's tri_of
    and pid - run_start at every sample below the total, on every set and
    shard (carry-in runs included; the cut set's offsets past the stream
    clamped in int32 as the plan stores them)."""
    carried = 0
    for name in vin.NAMES:
        scene = _scene(_set(name))
        plan = tgi._VoxelPlan(scene, vin.GRID, vin.SCALE, 4.0, vin.TOTAL)
        offs = plan.offsets32.numpy()
        s_len = vin.TOTAL // shards
        for i in range(shards):
            start = i * s_len
            pid, tri_of, run_start = tgi._stream_fills(plan.offsets, vin.TOTAL, i, shards)
            live = (pid < plan.total).numpy()
            tri, local = _model_lookup(offs, plan.n_total, start, s_len, plan.one_sample)
            np.testing.assert_array_equal(tri, tri_of.numpy()[live], err_msg=f"{name} {i}")
            np.testing.assert_array_equal(local, (pid - run_start).numpy()[live])
            carried += bool(live.any() and start not in set(plan.offsets.tolist()))
    assert carried > 0 or shards == 1   # some slice starts inside a run


def test_lookup_on_a_multi_sample_stream_of_exactly_its_triangles():
    """A stream of exactly T samples over triangles of several samples each
    (the planes set, total_samples = T: the stream is cut to the triangle
    count): the plan's one-sample flag is off, and the kernel's lookup with
    the plan's flag gives the plain version's fills, where t = pid would
    not."""
    s = _set("planes")
    plan = tgi._VoxelPlan(_scene(s), vin.GRID, vin.SCALE, 4.0, vin.TRIS)
    assert (vin.counts(s["tri_attr"], vin.TRIS) > 1).any()
    assert plan.n_total == vin.TRIS < int(plan.total) and not plan.one_sample
    pid, tri_of, run_start = tgi._stream_fills(plan.offsets, vin.TRIS, 0, 1)
    live = (pid < plan.total).numpy()
    offs = plan.offsets32.numpy()
    tri, local = _model_lookup(offs, plan.n_total, 0, vin.TRIS, plan.one_sample)
    np.testing.assert_array_equal(tri, tri_of.numpy()[live])
    np.testing.assert_array_equal(local, (pid - run_start).numpy()[live])
    wrong, _ = _model_lookup(offs, plan.n_total, 0, vin.TRIS, True)
    assert not np.array_equal(wrong, tri)


@pytest.mark.parametrize("shards", [2, 4])
def test_shards_max_equals_whole(shards):
    """The max of the shards' grids (the sharded frame's combine) is the
    whole stream's grid, on sets whose slices start inside a run."""
    for name in ("planes", "cut", "outside"):
        s = _set(name)
        scene = _scene(s)
        args, kw = _args(s)
        whole = tgi.voxelize_scene(scene, *args, **kw)
        parts = [tgi.voxelize_scene(scene, *args, **kw, shard_idx=i, shard_count=shards)
                 for i in range(shards)]
        np.testing.assert_array_equal(torch.stack(parts).amax(0).numpy(), whole.numpy())
        assert sum(int((p != 0).sum()) > 0 for p in parts) >= 2, name


def test_cpu_dispatch_counts_no_launch():
    s = _set("one_sample")
    before = (tgi.voxelize_scene.launches, tgi.decode_voxel_grid.launches)
    args, kw = _args(s)
    tgi.decode_voxel_grid(tgi.voxelize_scene(_scene(s), *args, **kw))
    assert (tgi.voxelize_scene.launches, tgi.decode_voxel_grid.launches) == before


def test_wrappers_reject_bad_inputs():
    s = _set("one_sample")
    scene = _scene(s)
    args, kw = _args(s)
    grid, scale, depth, mat, sdir, em = args

    def call(sc=scene, a=args, **over):
        return tgi.voxelize_scene(sc, *a, **{**kw, **over})

    bad = [
        (dict(shard_count=3), "divide"),
        (dict(shard_idx=2, shard_count=2), "shard_idx"),
        (dict(total_samples=0), "total_samples"),
    ]
    for over, match in bad:
        with pytest.raises(ValueError, match=match):
            call(**over)
    for a, match in (((grid, scale, depth[:, :32], mat, sdir, em), "square"),
                     ((grid, scale, depth, mat[:3], sdir, em), "sun_space_from_world"),
                     ((grid, scale, depth, mat, sdir.double(), em), "sun_dir"),
                     ((grid, scale, depth, mat, sdir, em[:2]), "sun_emission"),
                     ((grid, scale, depth, mat, sdir, (1.0, 2.0)), "sun_emission"),
                     ((0, scale, depth, mat, sdir, em), "grid_size")):
        with pytest.raises(ValueError, match=match):
            call(a=a)
    for field, value, match in (
            ("tri_attr", scene.tri_attr[:, :20], "tri_attr"),
            ("tri_attr", scene.tri_attr[:0], "tri_attr"),
            ("mat_id", scene.mat_id.float(), "mat_id"),
            ("tex_packed", scene.tex_packed[:, :, :-1], "width"),
            ("mat_id", scene.mat_id + vin.LAYERS, "layers")):
        with pytest.raises(ValueError, match=match):
            call(sc=types.SimpleNamespace(**{**vars(scene), field: value}))
    with pytest.raises(ValueError, match="int64"):
        tgi.decode_voxel_grid(torch.zeros((4, 4, 4), dtype=torch.int32))
    # 3 numbers in place of the emission tensor: the same grid
    np.testing.assert_array_equal(call(a=(grid, scale, depth, mat, sdir,
                                          tuple(vin.EMISSION.tolist()))).numpy(),
                                  call().numpy())
