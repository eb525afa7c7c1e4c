"""The frame's voxelize pass (shade/gi.py voxelize_lightgrid; on the card one
cooperative launch of csrc/voxelize.cu's voxelize_pass_kernel) and the
per-scene plan its callers hold (gi._VoxelPlan), on the CPU.

- voxelize_lightgrid's CPU route (decode_voxel_grid_plain of
  voxelize_scene_plain) against JAX's decode_voxel_grid(voxelize_scene(...))
  bit for bit on the seeded sets of tests/test_torch_voxelize_inputs.py
  (JAX op by op, once a set; every set has the same shapes, so its
  compiled ops serve them all).  Tolerance: none (f32 bits).
- The plan's one-sample flag (the kernels' thread a triangle, no search)
  holds on exactly the sets where every triangle has one sample and the
  stream holds them all.
- Every word the plain version packs is below 2^32, so the pass's u32
  scatter-max is the int64 one.
- The plan a FrameState holds is made once over frames that move the sun,
  and a plan made for another scene shape or stream is refused.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_shade_inputs as si
import test_torch_voxelize_inputs as vin
from test_torch_reference_ray_inputs import _one_thread  # noqa: F401 (the module's fixture)
from vulkan_pbr_renderer_tpu.shade import gi as jgi
from vulkan_pbr_renderer_tpu_torch.app import renderer as tr
from vulkan_pbr_renderer_tpu_torch.shade import gi as tgi
from vulkan_pbr_renderer_tpu_torch.shade import shadow as tshadow


@functools.cache
def _atlas():
    return vin.atlas()


@functools.cache
def _set(name):
    s = vin.SETS[name]()
    m, d = tshadow.sun_matrices(*s["sun"])
    s.update(sun_from_world=m.numpy(), sun_dir=d.numpy(), depth=vin.sun_depth())
    return s


def _scene(s, tris=None):
    packed, scale = _atlas()
    t = slice(None, tris)
    return types.SimpleNamespace(tri_attr=torch.from_numpy(s["tri_attr"][t].copy()),
                                 mat_id=torch.from_numpy(s["mat_id"][t].copy()),
                                 tex_packed=torch.from_numpy(packed),
                                 tex_scale=torch.from_numpy(scale))


def _args(s):
    return ((vin.GRID, vin.SCALE, torch.from_numpy(s["depth"]),
             torch.from_numpy(s["sun_from_world"]), torch.from_numpy(s["sun_dir"]),
             torch.from_numpy(vin.EMISSION)),
            dict(total_samples=vin.TOTAL, texture_lod=s["texture_lod"]))


@functools.cache
def _jax_grid(name):
    """JAX's decoded grid of a set, op by op."""
    s = _set(name)
    packed, scale = _atlas()
    scene = types.SimpleNamespace(tri_attr=jnp.asarray(s["tri_attr"]),
                                  mat_id=jnp.asarray(s["mat_id"]),
                                  tex_packed=jnp.asarray(packed), tex_scale=jnp.asarray(scale))
    words = jgi.voxelize_scene(scene, vin.GRID, vin.SCALE, jnp.asarray(s["depth"]),
                               jnp.asarray(s["sun_from_world"]), jnp.asarray(s["sun_dir"]),
                               jnp.asarray(vin.EMISSION), total_samples=vin.TOTAL,
                               texture_lod=s["texture_lod"])
    return np.asarray(jgi.decode_voxel_grid(words))


@pytest.mark.parametrize("name", vin.NAMES)
def test_voxelize_lightgrid_matches_jax(name):
    """The pass's CPU route, with its plan passed in and without, equals
    JAX's decoded grid bit for bit; no launch is counted."""
    s = _set(name)
    scene = _scene(s)
    args, kw = _args(s)
    plan = tgi._VoxelPlan(scene, vin.GRID, vin.SCALE, 4.0, vin.TOTAL)
    before = tgi.voxelize_lightgrid.launches
    got = tgi.voxelize_lightgrid(scene, *args, **kw, plan=plan)
    assert tgi.voxelize_lightgrid.launches == before
    assert got.dtype == torch.float32 and got.shape == (vin.GRID,) * 3 + (4,)
    want = _jax_grid(name)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(tgi.voxelize_lightgrid(scene, *args, **kw).numpy(),
                                  got.numpy())
    assert float(got[..., 3].sum()) > 0


def test_one_sample_flag_on_exactly_the_one_sample_sets():
    """The plan's flag: every count 1 and the stream holding every sample;
    offsets are then 0, 1, ..., T - 1, the kernels' t = pid."""
    flags = {}
    for name in vin.NAMES:
        scene = _scene(_set(name))
        plan = tgi._VoxelPlan(scene, vin.GRID, vin.SCALE, 4.0, vin.TOTAL)
        counts = vin.counts(_set(name)["tri_attr"])
        assert plan.one_sample == bool((counts == 1).all() and counts.sum() <= vin.TOTAL)
        if plan.one_sample:
            np.testing.assert_array_equal(plan.offsets.numpy(), np.arange(vin.TRIS))
        flags[name] = plan.one_sample
    assert [n for n, f in flags.items() if f] == ["one_sample"]
    # the same triangles in a stream shorter than their count: a cut stream
    cut = tgi._VoxelPlan(_scene(_set("one_sample")), vin.GRID, vin.SCALE, 4.0, vin.TRIS - 1)
    assert not cut.one_sample and cut.n_total == vin.TRIS - 1


@pytest.mark.parametrize("total", [vin.TRIS, vin.TRIS - 1, vin.TRIS + 1],
                         ids=["tris", "tris-1", "tris+1"])
def test_one_sample_flag_on_streams_near_the_triangle_count(total):
    """The flag on every set with a stream of about T samples: it holds
    exactly where every count is 1 and the stream holds them all, so not on
    a set of multi-sample triangles whose stream is cut to T (its true total
    is above T, its stream total T)."""
    for name in vin.NAMES:
        plan = tgi._VoxelPlan(_scene(_set(name)), vin.GRID, vin.SCALE, 4.0, total)
        counts = vin.counts(_set(name)["tri_attr"], total)
        assert plan.one_sample == bool((counts == 1).all() and counts.sum() <= total), name
    assert (vin.counts(_set("planes")["tri_attr"], total) > 1).any()


def test_words_fit_u32():
    """Every word of every set's plain grid, and the word of any radiance
    (huge, negative, infinite, NaN), lies in [0, 2^32): the u32 max of the
    pass is the int64 max."""
    for name in vin.NAMES:
        s = _set(name)
        args, kw = _args(s)
        words = tgi.voxelize_scene_plain(_scene(s), *args, **kw)
        assert int(words.min()) >= 0 and int(words.max()) < 2 ** 32
        u32 = words.numpy().astype(np.uint32)   # the pass's words
        np.testing.assert_array_equal(u32.astype(np.int64), words.numpy())
    rgb = torch.tensor([[1e30, 1e30, 1e30], [-5.0, 0.0, 3.0], [np.inf, 1.0, 0.5],
                        [np.nan, 2.0, 1.0], [0.0, 0.0, 0.0]], dtype=torch.float32)
    w = tgi._pack_voxel_sample(rgb)
    assert int(w.min()) >= 1 and int(w.max()) < 2 ** 32, w


def test_state_plan_made_once_over_sun_moves(monkeypatch):
    """render_frame makes the scene's plan on the first sun pass and keeps
    it in FrameState: 3 sun moves after frame 0, one plan, passed in every
    time; a fresh state makes its own."""
    made, calls = [], []
    plan_cls, pass_fn = tgi._VoxelPlan, tgi.voxelize_lightgrid

    class Counted(plan_cls):
        def __init__(self, *a, **k):
            made.append(self)
            super().__init__(*a, **k)

    def recording(*a, plan=None, **k):
        calls.append(plan)
        return pass_fn(*a, plan=plan, **k)

    monkeypatch.setattr(tgi, "_VoxelPlan", Counted)
    monkeypatch.setattr(tgi, "voxelize_lightgrid", recording)
    r = tr.Renderer(si.frame_config(16, 24), si.shade_scene("cpu"), device="cpu")
    cam = tr.make_camera((5.0, -6.0, 3.5), (0.0, 0.0, 1.0), r.cfg, device="cpu")
    for i in range(4):
        img = r.render(cam, (40.0 + 5.0 * i, 120.0))
        assert bool(torch.isfinite(img).all())
    assert r.state.voxelize_count == 4 and len(made) == 1
    assert calls == [made[0]] * 4 and r.state.voxel_plan is made[0]
    r.state = tr.init_frame_state(r.cfg, "cpu")
    r.render(cam, (40.0, 120.0))
    assert len(made) == 2 and r.state.voxel_plan is made[1]


def test_plan_of_another_scene_refused():
    """A plan made for another triangle count, atlas, grid, scale, density or
    stream raises ValueError in both wrappers; the plan's own scene
    passes."""
    s = _set("planes")
    scene = _scene(s)
    args, kw = _args(s)
    plan = tgi._VoxelPlan(scene, vin.GRID, vin.SCALE, 4.0, vin.TOTAL)
    fewer = _scene(s, vin.TRIS - 1)
    small_atlas = types.SimpleNamespace(**{**vars(scene),
                                           "tex_packed": scene.tex_packed[:2].contiguous()})
    for fn in (tgi.voxelize_lightgrid, tgi.voxelize_scene):
        for sc, a, k in ((fewer, args, kw), (small_atlas, args, kw),
                         (scene, (vin.GRID * 2,) + args[1:], kw),
                         (scene, (vin.GRID, vin.SCALE * 2) + args[2:], kw),
                         (scene, args, {**kw, "samples_per_voxel_area": 2.0}),
                         (scene, args, {**kw, "total_samples": 2 * vin.TOTAL})):
            with pytest.raises(ValueError, match="plan was made"):
                fn(sc, *a, **k, plan=plan)
        fn(scene, *args, **kw, plan=plan)
    with pytest.raises(ValueError, match="sun_emission"):
        tgi.voxelize_lightgrid(scene, *args[:5], (1.0, 2.0), **kw, plan=plan)
