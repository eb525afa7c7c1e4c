"""The port's row-sharded frame (parallel/sharding.py) on the CPU: four gloo
ranks, one process each, against the port's single-device frame and the
JAX package's sharded frame (tests/test_parallel.py's checks).

The ranks run once for the whole module (`launch` spawns them; the JAX
frame and the single-device frames run meanwhile in this process), as a
dp=2 x sp=2 mesh over tests/test_parallel.py's `_small_cfg` (128x256) and
its scene, each run from a fresh state:
  dp slice 0: one frame through the brute-force raster ("xla") from
              test_parallel.py:167's second camera, then 3 frames along
              test_parallel.py:105's cameras through K1's plain version
              ("pallas");
  dp slice 1: one "xla" frame from each of those 3 cameras, each from a
              fresh state, held to JAX's sharded frame of the same camera.

Tolerances (test_parallel.py:80-96, 156-159): one frame's image rtol = atol
= 2e-4, each state leaf rtol = atol = 1e-3 (bf16 leaves rtol one bf16 ulp,
2^-7), the loop's images 5e-4; against JAX's sharded frame SSIM >= 0.995
and the packed voxel words exactly equal.  The cameras see sky at the top
of the frame, which the sharded frame shades at full resolution and the
single-device frame at half (lighting.py:305-318); those pixels stay inside
the bounds above.

Against JAX's jitted sharded step, the port's first frames at this
divisor-1 config score SSIM 0.99544, 0.99707 and 0.99456 from the three
cameras of LOOP_CAMS (sharded and single-device alike).  JAX's own
single-device frame under jax.disable_jit scores 0.99578, 0.99717 and
0.99462 against the same jitted step, and the port's frames score 0.99951,
0.99989 and 0.99986 against that eager frame: the port is
nearer JAX's eager arithmetic than JAX's eager and jitted frames are to
each other.  The split starts where world positions are reconstructed from
depth near the far plane, which cancels catastrophically: eager, jitted
and port positions differ by up to ~1e-3 relative at a few lanes in a
thousand, and downstream branches move with them (from the third camera
the GI screen trace's status differs at 12 diffuse and 12 specular lanes
of 32,768 between JAX eager and jit, 40 and 22 between the port and jit).
So the third camera is a strict xfail: it measures the reference's own
eager-versus-jit split, which no rounding of the port's can remove on the
CPU.
"""

import threading

import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu_torch import convert
from vulkan_pbr_renderer_tpu_torch.app import renderer as tr
from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
from vulkan_pbr_renderer_tpu_torch.parallel import sharding
from vulkan_pbr_renderer_tpu_torch.shade import gi as tgi
from vulkan_pbr_renderer_tpu_torch.utils import image

# tests/test_parallel.py::_small_cfg
SMALL = dict(width=128, height=256, shadow_map_size=128, lightgrid_size=16,
             lightgrid_extent=10.0, prefiltered_env_size=16, prefiltered_env_min_size=8,
             prefilter_samples=64, brdf_lut_size=16, brdf_lut_samples=64, irradiance_size=8,
             irradiance_samples=32, bloom_pass_count=3, gi_screen_trace_steps=4,
             gi_diffuse_steps=4, gi_specular_steps=4, light_shaft_steps=4)
SUN = (35.0, 80.0)
LOOP_CAMS = [((0.0, -20.0 + 0.5 * i, 3.0 + 0.1 * i), (0.0, 0.0, 3.0)) for i in range(3)]
XLA_CAM = ((0.0, -16.0, 3.0), (0.0, 0.0, 3.0))


def _port_cfg(scene):
    """The config the sharded frame renders (divisor 1, the voxelize stream
    right-sized)."""
    cfg = sharding.sharded_config(scene, RenderConfig(
        **{k: v for k, v in SMALL.items() if k in RenderConfig.__dataclass_fields__}))
    assert cfg.gi_res_divisor == cfg.shaft_res_divisor == 1 and cfg.voxelize_samples > 0
    return cfg


def _port_inputs(scene_np, raw, lut):
    scene = convert.scene_from_numpy(scene_np, device="cpu")
    pre, lut = convert.bakes_from_numpy(raw, lut, device="cpu")
    return scene, pre, lut, _port_cfg(scene)


def _camera(pose, cfg):
    return tr.make_camera(*pose, cfg, device="cpu")


def _state_numpy(state):
    """The state's leaves as numpy; the voxelize plan (a per-scene cache of
    tensors, not a frame's state) stays behind."""
    return {k: v.float().numpy() if torch.is_tensor(v) else v for k, v in vars(state).items()
            if k != "voxel_plan"}


def _rank_main(scene_np, raw, lut):
    """One rank of the dp=2 x sp=2 mesh; returns numpy results."""
    import torch.distributed as dist

    refused = []
    for kw, err in ((dict(backend="nccl", device="cpu"), ValueError), (dict(), RuntimeError)):
        try:
            sharding.make_mesh(dp=2, **kw)
        except err as e:
            refused.append(str(e))
    mesh = sharding.make_mesh(dp=2, device="cpu")
    assert (mesh.dp, mesh.sp, mesh.rank) == (2, 2, dist.get_rank())
    scene, pre, lut, cfg = _port_inputs(scene_np, raw, lut)
    out = dict(dp_idx=mesh.dp_idx, sp_idx=mesh.sp_idx, refused=refused)
    runs = ([("xla", [XLA_CAM], False), ("pallas", LOOP_CAMS, False)] if mesh.dp_idx == 0
            else [("xla", LOOP_CAMS, True)])
    for backend, poses, fresh in runs:
        step = sharding.sharded_frame_fn(scene, cfg, mesh, backend)
        state = tr.init_frame_state(cfg, "cpu")
        out[backend] = []
        for pose in poses:
            if fresh:
                state = tr.init_frame_state(cfg, "cpu")
            img = step(state, _camera(pose, cfg), SUN, pre, lut)
            out[backend].append((img.numpy(), _state_numpy(state)))
    # the packed voxel words of the last "xla" frame's sun map, combined as
    # the step combines them
    sun_depth = torch.from_numpy(out["xla"][0][1]["sun_depth"])
    fi = tr.frame_inputs(tr.init_frame_state(cfg, "cpu"), _camera(XLA_CAM, cfg), SUN, cfg)
    words = tgi.voxelize_scene(scene, cfg.lightgrid_size, cfg.lightgrid_scale, sun_depth,
                               fi.sun_from_world, fi.sun_dir,
                               cfg.voxelize_sun_emission_scale * torch.tensor(cfg.sun_color),
                               total_samples=cfg.voxelize_samples, shard_idx=mesh.sp_idx,
                               shard_count=mesh.sp)
    dist.all_reduce(words, op=dist.ReduceOp.MAX, group=mesh.sp_group)
    out["words"] = words.numpy()
    return out


def _jax_resources():
    """tests/test_parallel.py's config, scene and bakes."""
    import jax.numpy as jnp

    from vulkan_pbr_renderer_tpu.assets import build_scene, procedural, suntemple
    from vulkan_pbr_renderer_tpu.bake import ibl
    from vulkan_pbr_renderer_tpu.config import RenderConfig as JaxConfig
    from vulkan_pbr_renderer_tpu.gpu import sampling

    cfg = JaxConfig(**SMALL)
    scene = build_scene(suntemple.build_parts(0.15), suntemple.materials(), texture_size=16)
    atlas = sampling.build_cube_mip_atlas(jnp.asarray(procedural.make_sky_cubemap(16)))
    raw = ibl.bake_prefiltered_env(atlas, 16, cfg.prefiltered_env_size,
                                   cfg.prefiltered_env_min_size, 64)
    return cfg, scene, raw, ibl.bake_brdf_lut(cfg.brdf_lut_size, 64)


def _jax_sharded_frame(jcfg, scene, raw, lut):
    """JAX's own sharded step on make_mesh(2, dp=1) (the conftest's virtual
    CPU devices): the first frame from each camera of LOOP_CAMS, each from a
    fresh state (the step compiles once), and the packed voxel words of the
    sun map, op by op (test_torch_gi.py; a thread compiles those ops on a
    stand-in map while the step compiles)."""
    import jax.numpy as jnp

    from vulkan_pbr_renderer_tpu.app.renderer import (frame_inputs, init_frame_state,
                                                      make_camera)
    from vulkan_pbr_renderer_tpu.gpu import sampling
    from vulkan_pbr_renderer_tpu.parallel import sharding as jsharding
    from vulkan_pbr_renderer_tpu.shade import gi as jgi

    ref_cfg = jcfg.replace(gi_res_divisor=1, shaft_res_divisor=1, gi_temporal_div=1)
    cams = [make_camera(*pose, jcfg) for pose in LOOP_CAMS]
    sun = jnp.asarray(SUN, jnp.float32)
    fi = frame_inputs(init_frame_state(ref_cfg), cams[0], sun, ref_cfg)
    cap = jgi.voxelize_sample_capacity(scene, jcfg.lightgrid_size, jcfg.lightgrid_scale)

    def words(sun_depth):
        return np.asarray(jgi.voxelize_scene(
            scene, jcfg.lightgrid_size, jcfg.lightgrid_scale, jnp.asarray(sun_depth),
            fi.sun_from_world, fi.sun_dir,
            jcfg.voxelize_sun_emission_scale * jnp.asarray(jcfg.sun_color),
            total_samples=cap)).astype(np.int64)

    sm = jcfg.shadow_map_size
    warm = threading.Thread(target=words, args=(np.ones((sm, sm), np.float32),))
    warm.start()
    try:
        step = jsharding.sharded_frame_fn(scene, jcfg, jsharding.make_mesh(2, dp=1), "xla")
        pre = sampling.pack_cube_mip_atlas_window(raw, 16)
        imgs = []
        for cam in cams:
            states, img = step(jsharding.stack_states([init_frame_state(ref_cfg)]),
                               jsharding.stack_cams([cam]), sun, pre, lut)
            imgs.append(np.asarray(img[0]))
        sun_depth = np.asarray(states.sun_depth[0])
    finally:
        warm.join()
    return imgs, words(sun_depth), sun_depth


def _single_device(scene_np, raw, lut):
    """The port's render_frame at the divisor-1 config: the loop's frames
    ("pallas") and XLA_CAM's frame ("xla"), with the state after each."""
    scene, pre, lut, cfg = _port_inputs(scene_np, raw, lut)
    out = {}
    for backend, poses in (("pallas", LOOP_CAMS), ("xla", [XLA_CAM])):
        state = tr.init_frame_state(cfg, "cpu")
        frames = []
        for pose in poses:
            img = tr.render_frame(scene, state, _camera(pose, cfg), SUN, pre, lut, cfg, backend)
            frames.append((img.numpy(), _state_numpy(state)))
        out[backend] = frames
    return out


@pytest.fixture(scope="module")
def runs():
    jcfg, scene, raw, lut = _jax_resources()
    scene_np = {k: np.asarray(v) for k, v in scene._asdict().items()}
    raw_np, lut_np = np.asarray(raw), np.asarray(lut)
    out = {}

    def spawn():
        out["ranks"] = sharding.launch(_rank_main, 4, "gloo", scene_np, raw_np, lut_np)

    thread = threading.Thread(target=spawn)   # the ranks run while JAX compiles its step
    thread.start()
    try:
        out["jax"] = _jax_sharded_frame(jcfg, scene, raw, lut)
        out["single"] = _single_device(scene_np, raw_np, lut_np)
    finally:
        thread.join()
    assert "ranks" in out, "the ranks failed (see the output above)"
    return dict(out, num_tris=int(scene.tri_attr.shape[0]))


def _slice(runs, dp_idx):
    out = [r for r in runs["ranks"] if r["dp_idx"] == dp_idx]
    assert [r["sp_idx"] for r in out] == [0, 1]
    return out


def _leaf_close(a, b, name):
    if isinstance(b, np.ndarray):
        rt = 2 ** -7 if name == "prev_pyramid" else 1e-3   # bf16 stored: one bf16 ulp
        np.testing.assert_allclose(a, b, rtol=rt, atol=1e-3, err_msg=f"state leaf {name}")
    else:
        assert a == b, f"state leaf {name}: {a} != {b}"


def test_sharded_frame_matches_single_device(runs):
    """One sp=2 frame ("xla") == render_frame at the divisor-1 config: the
    image and every state leaf (test_parallel.py:51-96)."""
    img_ref, state_ref = runs["single"]["xla"][0]
    for rank in _slice(runs, 0):
        img, state = rank["xla"][0]
        assert img.shape == (256, 128, 3)
        np.testing.assert_allclose(img, img_ref, rtol=2e-4, atol=2e-4)
        for name, want in state_ref.items():
            _leaf_close(state[name], want, name)
        assert state["frame_idx"] == 1 and state["voxelize_count"] == 1


def test_sharded_frame_loop_matches_single_device(runs):
    """3 frames: the temporal carry (TAA history, the sweep axis, the cached
    sun map, the bloom pyramid) as in the single-device loop
    (test_parallel.py:99-127)."""
    for rank in _slice(runs, 0):
        for i, ((img, _), (img_ref, _)) in enumerate(zip(rank["pallas"],
                                                         runs["single"]["pallas"])):
            np.testing.assert_allclose(img, img_ref, rtol=5e-4, atol=5e-4, err_msg=f"frame {i}")
        last, last_ref = rank["pallas"][-1][1], runs["single"]["pallas"][-1][1]
        assert last["frame_idx"] == 3 and last["voxelize_count"] == 1
        np.testing.assert_array_equal(last["sun_depth"], last_ref["sun_depth"])


def test_sharded_pallas_matches_single_device_pallas(runs):
    """The folded kernel's route with a row origin (test_parallel.py:130-159):
    the first frame within the one-frame bounds, and the overflow counters
    report real work and no overflow."""
    img_ref, _ = runs["single"]["pallas"][0]
    cap = RenderConfig().pair_capacity_factor * runs["num_tris"]
    for rank in _slice(runs, 0):
        np.testing.assert_allclose(rank["pallas"][0][0], img_ref, rtol=2e-4, atol=2e-4)
        ovf = rank["pallas"][-1][1]["raster_overflow"]
        assert ovf[0] == 0 and 0 < ovf[1] <= cap


def test_sharded_dp_slices_are_independent(runs):
    """The two dp slices render their own cameras at once
    (test_parallel.py:162-175); the sp ranks of a slice return the same
    gathered image."""
    a, b = _slice(runs, 0), _slice(runs, 1)
    for s in (a, b):
        np.testing.assert_array_equal(s[0]["xla"][0][0], s[1]["xla"][0][0])
        assert np.isfinite(s[0]["xla"][0][0]).all()
    assert np.abs(a[0]["xla"][0][0] - b[0]["xla"][0][0]).mean() > 1e-4


@pytest.mark.parametrize("pose", [0, 1, pytest.param(2, marks=pytest.mark.xfail(
    strict=True, raises=AssertionError,
    reason="divisor-1 fault: the port scores SSIM 0.99456 < 0.995 against JAX's jitted "
           "sharded step at this camera, and JAX's own eager frame (jax.disable_jit) "
           "scores 0.99462 against it (module docstring)"))])
def test_sharded_frame_matches_jax_sharded_frame(runs, pose):
    """Against JAX's sharded step on make_mesh(2, dp=1), with the same scene,
    bakes and camera, each a fresh first frame from a camera of LOOP_CAMS:
    SSIM >= 0.995, and the packed voxel words of the two sun maps exactly
    equal (the port's combined over its two ranks)."""
    imgs_jax, words_jax, _ = runs["jax"]
    for rank in _slice(runs, 1):
        np.testing.assert_array_equal(rank["words"], words_jax)
        assert (rank["words"] != 0).sum() > 0
        s = image.ssim(rank["xla"][pose][0], imgs_jax[pose])
        assert s >= 0.995, f"SSIM {s}"


def test_make_mesh_refuses_without_cards(runs):
    """make_mesh names its backend and device: "nccl" without a card per rank
    raises, and so does the default device without a card."""
    for rank in runs["ranks"]:
        assert len(rank["refused"]) == 2
        assert "nccl" in rank["refused"][0] and "device='cpu'" in rank["refused"][1]


def _fail_on_rank_1():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    return dist.get_rank()


def test_launch_fails_when_a_rank_fails():
    with pytest.raises(Exception, match="rank 1 fails"):
        sharding.launch(_fail_on_rank_1, 2, "gloo")
