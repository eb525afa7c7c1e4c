"""Seed-made inputs of one ray of the fast GI's probe and hi-z screen terms
and of its economy mode (shade/gi.py::screen_ray_resolve and
probe_ray_resolve, the functions of csrc/gi_screen_ray.cu), as numpy arrays
and call arguments, shared by the CPU tests, the card tests and
chip_smoke.py.

The scene is test_torch_gi_ray_inputs.random_rays' (a random lightgrid of
open, translucent and solid voxels, lanes on screen at view depths 1.5-12
and a tenth far outside the grid, a bumpy depth table, a random bf16
pyramid) with a deeper pyramid, so that a per-lane level and the probe
level 1 have texels.  SETS names each kernel's seeded sets: every knob
branch of the probes term, the hi-z term and the economy mode; every set
has one shape.  Imports no jax.
"""

import numpy as np
import pytest

from test_torch_gi_ray_inputs import EXTENT, random_rays

N_LANES = 2048
NEAR, FAR = 0.1, 100.0     # random_rays' projection

# (name, kind, specular ray, RenderConfig changes): "fog" sets run
# gi_screen_ray, "fast" sets gi_probe_ray
SETS = (
    ("probes", "fog", False, dict(gi_fast_screen_mode="probes")),
    ("probes_knobs", "fog", True, dict(
        gi_fast_screen_mode="probes", gi_fast_probe_growth=1.3, gi_fast_probe_jitter=0.5,
        gi_fast_probe_solid_taps=2, gi_fast_probe_overshoot=2.0, gi_fast_probe_dist_mip=0.4,
        gi_fast_probe_to_stop=True)),
    ("probes_gamma", "fog", False, dict(
        gi_fast_screen_mode="probes", gi_fast_probe_gamma=2.0, gi_fast_probe_solid_taps=3,
        gi_fast_edge_fallback=False, gi_fast_probe_level=0, gi_fast_probe_points=7,
        gi_fast_fog_trilinear=False)),
    ("probes_one", "fog", True, dict(gi_fast_screen_mode="probes", gi_fast_probe_points=1,
                                     gi_fast_probe_to_stop=True)),
    ("hiz", "fog", False, dict(gi_fast_screen_mode="hiz")),
    ("hiz_solid", "fog", True, dict(gi_fast_screen_mode="hiz", gi_hiz_solid=0.2,
                                    gi_fast_probe_to_stop=True, gi_hiz_iters=6)),
    ("hiz_nearest", "fog", False, dict(gi_fast_screen_mode="hiz", gi_fast_fog_trilinear=False,
                                       gi_hiz_thickness=3.0, gi_fast_probe_level=0)),
    ("economy", "fast", False, dict(gi_fast_march=False, gi_fast_screen_mode="probes")),
    ("economy_mip", "fast", True, dict(gi_fast_march=False, gi_fast_screen_mode="hiz",
                                       gi_fast_probe_dist_mip=0.5, gi_fast_spec_hit_steps=5,
                                       gi_fast_samples=3, gi_fast_sample_spread=2.0)),
    ("economy_one", "fast", False, dict(gi_fast_march=False, gi_fast_screen_mode="probes",
                                        gi_fast_probe_points=1, gi_fast_diffuse_hit_steps=4,
                                        gi_fast_samples=1)),
    ("economy_no_screen", "fast", True, dict(gi_fast_march=False)),
)


def screen_rays(seed, n=N_LANES):
    """(arrays, scalars): random_rays' arrays with a 5-level pyramid and
    clip_from_world / world_from_clip, and its scalars."""
    arrays, scalars = random_rays(seed, n=n, prev=(24, 32), levels=5)
    cfv = arrays["clip_from_view"].astype(np.float64)
    cfw = cfv @ arrays["view_from_world"].astype(np.float64)
    arrays["clip_from_world"] = cfw.astype(np.float32)
    arrays["world_from_clip"] = np.linalg.inv(cfw).astype(np.float32)
    return arrays, scalars


def set_config(scalars, changes):
    """The RenderConfig of a set: the grid's extent, the pyramid's levels,
    random_rays' near and far planes, then `changes`."""
    from vulkan_pbr_renderer_tpu_torch.config import RenderConfig

    return RenderConfig(lightgrid_extent=EXTENT, bloom_pass_count=scalars["levels"],
                        z_near=NEAR, z_far=FAR, **changes)


def screen_call_args(arrays, scalars, device, kind, spec, **changes):
    """The positional arguments of gi.screen_ray_resolve_plain for `arrays`
    on `device`: kind "fog" (the probes or hiz term of
    changes["gi_fast_screen_mode"]) or "fast" (the economy mode), the
    diffuse ray's parameters or (spec) the specular ray's.  The probe depth
    is the 2 x 2 minimum of the depth table (its full resolution for
    "fast"), the hi-z term's its build_hiz_atlas pyramid."""
    import torch

    from vulkan_pbr_renderer_tpu_torch.shade import gi, gi_modes

    t = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    cfg = set_config(scalars, dict(lightgrid_size=arrays["grid"].shape[0], **changes))
    ph, pwid = scalars["prev_h"], scalars["prev_w"]
    depth_half = gi_modes._min_depth(t["depth"], cfg.gi_fast_probe_depth_div)
    if kind == "fast":
        steps = cfg.gi_fast_spec_hit_steps if spec else cfg.gi_fast_diffuse_hit_steps
        step_scale = cfg.gi_specular_step_scale if spec else cfg.gi_diffuse_step_scale
        ss = cfg.gi_specular_ss_intensity if spec else cfg.gi_diffuse_ss_intensity
        rp = gi.screen_ray_params(cfg, "fast", steps, step_scale, ss, ph, pwid,
                                  dist_voxels=4.0 if spec else 2.5)
        depth, fgrid = t["depth"], None
    else:
        steps = cfg.gi_fast_hit_steps_spec if spec else cfg.gi_fast_hit_steps
        step_scale = cfg.gi_fast_hit_step_scale_spec if spec else cfg.gi_fast_hit_step_scale
        ss = cfg.gi_specular_ss_intensity if spec else cfg.gi_diffuse_ss_intensity
        rp = gi.screen_ray_params(cfg, kind, steps, step_scale, ss, ph, pwid,
                                  tuple(depth_half.shape))
        depth = depth_half
        if rp.term == "hiz":
            depth, _ = gi.build_hiz_atlas(depth_half, cfg.gi_hiz_levels)
        fgrid = None if cfg.gi_fast_fog_trilinear else gi.pack_grid_f16_nearest(t["grid"])
    fog = t["roughness"] if spec else cfg.gi_diffuse_foggyness
    return (gi.quantize_grid_u8(t["grid"]), fgrid, depth.contiguous(),
            t["atlas"].to(torch.bfloat16), t["clip_from_world"], t["world_from_clip"],
            t["view_from_world"], t["camera_pos"], t["pw"], t["rd"], t["noise"], fog, rp)


def set_call_args(name, device, seed=70, n=N_LANES):
    """screen_call_args of the set `name` of SETS on seed `seed`'s lanes."""
    _, kind, spec, changes = next(s for s in SETS if s[0] == name)
    arrays, scalars = screen_rays(seed, n=n)
    return screen_call_args(arrays, scalars, device, kind, spec, **changes)


def wrapper_call(args):
    """gi.screen_ray_resolve or gi.probe_ray_resolve (by rp.kind) on the
    plain version's arguments `args`."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    (table, fgrid, depth, atlas, cfw, wfc, vfw, cam, pw, rd, noise, fog, rp) = args
    if rp.kind == "fast":
        return gi.probe_ray_resolve(table, depth, atlas, cfw, pw, rd, rp)
    return gi.screen_ray_resolve(*args)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions on one CPU thread while a module that imports this
    fixture runs: their bits do not depend on the thread count, and on a
    loaded machine PyTorch's thread pool made these small ops ~20x slower."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sets_cover_every_status():
    """Through the plain version on the CPU: every set of a screen term has
    resolved lanes, the probes with the edge fallback have fallback lanes,
    every set has march lanes, and the knobs' branches run (taps, hi-z
    rounds, march_to_hit, samples)."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    for name, kind, _, changes in SETS:
        args = set_call_args(name, "cpu")
        rp = args[-1]
        work = {}
        _, status = gi.screen_ray_resolve_plain(*args, work=work)
        counts = {int(k): int(v) for k, v in zip(*np.unique(status.numpy(), return_counts=True))}
        assert counts.get(2, 0) > 20, (name, counts)
        if rp.term is not None:
            assert counts.get(3, 0) > 20, (name, counts)
        if rp.term == "probes" and rp.edge_fallback:
            assert counts.get(1, 0) > 20, (name, counts)
        totals = {k: int(v.sum()) for k, v in work.items()}
        if rp.solid_taps:
            assert totals["taps"] > 0, (name, totals)
        if rp.term == "hiz":
            assert totals["hiz"] > N_LANES, (name, totals)
        if kind == "fast":
            assert totals["sample"] > 0, (name, totals)
            if rp.march_steps and rp.term:
                assert totals["hit"] > N_LANES, (name, totals)
