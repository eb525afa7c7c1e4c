"""Seed-made inputs of one fast-GI ray (shade/gi.py::fast_ray_resolve), as
numpy arrays, shared by the CPU tests, the card tests and chip_smoke.py.

A 60-degree camera over a random lightgrid of half-open, translucent and
solid voxels; lanes on screen at view depths 1.5-12, a tenth of them far
outside the grid; a bumpy depth table at view depths ~2-40; a random bf16
pyramid.  The mix gives every trace outcome: lanes that leave the screen
(status 1), that exhaust the trace budget (2), that resolve on a solid
crossing (3), and translucent crossings that re-arm; the test below holds
them to that.  Imports no jax.
"""

import numpy as np

EXTENT = 8.0          # world units of the grid's half width: lightgrid_scale 1/8


def _look_at(eye, target, up=(0.0, 0.0, 1.0)):
    """view_from_world for +X right, +Y down, +Z forward (utils/math3d.look_at)."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    f = target - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    d = np.cross(f, r)
    m = np.eye(4)
    m[:3, :3] = np.stack([r, d, f])
    m[:3, 3] = -(m[:3, :3] @ eye)
    return m


def random_rays(seed, n=3072, d=16, th=48, tw=64, prev=(24, 32), levels=3):
    """(arrays, scalars): arrays holds grid [d,d,d,4] f32, depth [th,tw],
    atlas [prev_h, wa, 3] f32 (bf16-representable), view_from_world,
    clip_from_view, world_from_view [4,4], camera_pos [3], pw, rd, pv
    [n,3], noise and roughness [n]; scalars the lightgrid scale and the
    pyramid's (prev_h, prev_w, levels)."""
    rng = np.random.default_rng(seed)
    grid = rng.uniform(0.0, 3.0, (d, d, d, 4)).astype(np.float32)
    kind = rng.random((d, d, d))
    grid[..., 3] = np.where(kind < 0.45, 0.0, np.where(kind < 0.7, rng.uniform(0.05, 0.3, kind.shape),
                                                      rng.uniform(0.3, 1.0, kind.shape)))
    eye = np.array([rng.uniform(-3, 3), -7.0, rng.uniform(1.0, 3.0)])
    vfw = _look_at(eye, (0.0, 0.0, 0.5))
    wfv = np.linalg.inv(vfw)
    fov, near, far = np.deg2rad(60.0), 0.1, 100.0
    f = 1.0 / np.tan(fov / 2.0)
    cfv = np.zeros((4, 4))
    cfv[0, 0], cfv[1, 1] = f / (tw / th), f
    cfv[2, 2], cfv[2, 3], cfv[3, 2] = far / (far - near), -far * near / (far - near), 1.0
    z = rng.uniform(1.5, 12.0, n)
    far_lanes = rng.random(n) < 0.1
    z[far_lanes] = rng.uniform(20.0, 40.0, far_lanes.sum())
    ndc = rng.uniform(-0.95, 0.95, (n, 2))
    pv = np.stack([ndc[:, 0] * z / cfv[0, 0], ndc[:, 1] * z / cfv[1, 1], z], -1)
    pw = pv @ wfv[:3, :3].T + wfv[:3, 3]
    rd = rng.normal(size=(n, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    # view depth z -> stored depth p22 + p23 / z; min-filtered for plateaus
    zd = rng.uniform(2.0, 40.0, (th + 1, tw + 1))
    zd = np.minimum.reduce([zd[i:i + th, j:j + tw] for i in (0, 1) for j in (0, 1)])
    depth = cfv[2, 2] + cfv[2, 3] / zd
    ph, pwid = prev
    wa = sum(max(1, pwid >> k) for k in range(levels))
    atlas = rng.uniform(0.0, 3.0, (ph, wa, 3)).astype(np.float32)
    atlas = (atlas.view(np.uint32) & 0xFFFF0000).view(np.float32)   # bf16 values
    f32 = np.float32
    arrays = dict(grid=grid, depth=depth.astype(f32), atlas=atlas,
                  view_from_world=vfw.astype(f32), clip_from_view=cfv.astype(f32),
                  world_from_view=wfv.astype(f32), camera_pos=eye.astype(f32),
                  pw=pw.astype(f32), rd=rd.astype(f32), pv=pv.astype(f32),
                  noise=rng.uniform(0.0, 1.0, n).astype(f32),
                  roughness=rng.uniform(0.05, 1.0, n).astype(f32))
    return arrays, dict(lightgrid_scale=1.0 / EXTENT, prev_h=ph, prev_w=pwid, levels=levels)


def ray_call_args(arrays, scalars, device, spec=False, **changes):
    """The positional arguments of gi.fast_ray_resolve (and its plain
    version) for `arrays` on `device`: the diffuse ray's parameters of
    RenderConfig, or with spec the specular ray's (per-lane foggyness from
    the roughness); `changes` are RenderConfig fields (gi_fast_fog_trilinear,
    gi_fast_screen_probe, gi_trace_*)."""
    import torch

    from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    t = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    cfg = RenderConfig(lightgrid_size=arrays["grid"].shape[0], lightgrid_extent=EXTENT,
                       bloom_pass_count=scalars["levels"], **changes)
    if spec:
        rp = gi.ray_params(cfg, cfg.gi_fast_hit_steps_spec, cfg.gi_fast_hit_step_scale_spec,
                           cfg.gi_specular_ss_intensity, scalars["prev_h"], scalars["prev_w"])
        fog = t["roughness"]
    else:
        rp = gi.ray_params(cfg, cfg.gi_fast_hit_steps, cfg.gi_fast_hit_step_scale,
                           cfg.gi_diffuse_ss_intensity, scalars["prev_h"], scalars["prev_w"])
        fog = cfg.gi_diffuse_foggyness
    fgrid = None if cfg.gi_fast_fog_trilinear else gi.pack_grid_f16_nearest(t["grid"])
    return (gi.quantize_grid_u8(t["grid"]), fgrid, t["depth"], t["atlas"].to(torch.bfloat16),
            t["view_from_world"], t["clip_from_view"], t["world_from_view"], t["camera_pos"],
            t["pw"], t["rd"], t["pv"], t["noise"], fog, rp)


def test_random_rays_cover_every_outcome():
    """Through the plain version on the CPU, both rays' lanes end in every
    status, some start outside the grid and some crossings re-arm."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    arrays, scalars = random_rays(40, n=2048)
    assert (np.abs(arrays["pw"] * scalars["lightgrid_scale"]) > 1.0).any(-1).sum() > 100
    for spec in (False, True):
        work = {}
        _, status = gi.fast_ray_resolve_plain(*ray_call_args(arrays, scalars, "cpu", spec=spec),
                                              work=work)
        counts = {int(k): int(v) for k, v in zip(*np.unique(status.numpy(), return_counts=True))}
        assert set(counts) == {1, 2, 3} and min(counts.values()) > 100, counts
        assert int(work["taps"].sum()) > counts[3]   # crossings beyond the resolved ones re-armed
