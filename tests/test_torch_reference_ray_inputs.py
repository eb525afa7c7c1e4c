"""Seed-made inputs of one reference-GI ray (shade/gi.py::reference_ray_resolve,
the hybrid screen + voxel march), as numpy arrays, shared by the CPU tests,
the card tests and chip_smoke.py.

The lanes of test_torch_gi_ray_inputs.random_rays (a 60-degree camera over
a random lightgrid of open, translucent and solid voxels; lanes on screen at
view depths 1.5-12, a tenth of them far outside the grid; a bumpy trace
depth; a random bf16 pyramid), with each lane's unit vector toward the
camera and the inverse projection added.  SETS names the seeded cases, all
of one lane count, so that JAX's op-by-op compiles serve every case: the
diffuse and the specular ray at RenderConfig's values (scalar and per-lane
foggyness), a short trace budget, and a denser grid.  Between them they
give every status (1 off screen, 2 the voxel march, 3 resolved), crossings
that are translucent and boost the step, and lanes where no voxel opens;
the test below holds them to that.  Imports no jax.
"""

import numpy as np
import pytest
import torch

from test_torch_gi_ray_inputs import EXTENT, random_rays

N_LANES = 2048

# (name, seed, specular ray, RenderConfig changes, solid share of the grid
# or None for random_rays' own): the CPU tests, the card tests and
# chip_smoke.py's phase 3i take these
SETS = [
    ("diffuse", 60, False, {}, None),
    ("specular", 61, True, {}, None),
    ("short_trace", 62, False, dict(gi_screen_trace_steps=7), None),
    ("dense", 63, True, dict(gi_specular_foggyness_is_roughness=False), 0.3),
]


def reference_rays(seed, n=N_LANES, solid=None, **kw):
    """(arrays, scalars) of random_rays(seed, n, **kw) plus view_from_clip
    [4,4] and vd [n,3] (the unit vector from pw toward the camera).  With
    `solid`, that share of the grid's voxels is made solid (alpha 0.6-1)."""
    arrays, scalars = random_rays(seed, n=n, **kw)
    if solid is not None:
        rng = np.random.default_rng(1000 + seed)
        g = arrays["grid"].copy()
        pick = rng.random(g.shape[:3]) < solid
        g[..., 3] = np.where(pick, rng.uniform(0.6, 1.0, g.shape[:3]), g[..., 3])
        arrays["grid"] = g.astype(np.float32)
    vfc = np.linalg.inv(arrays["clip_from_view"].astype(np.float64))
    vd = arrays["camera_pos"][None, :].astype(np.float64) - arrays["pw"]
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    arrays = dict(arrays, view_from_clip=vfc.astype(np.float32), vd=vd.astype(np.float32))
    return arrays, scalars


def set_arrays(name):
    """(arrays, scalars, specular, changes) of the seeded set `name`."""
    _, seed, spec, changes, solid = next(s for s in SETS if s[0] == name)
    arrays, scalars = reference_rays(seed, solid=solid)
    return arrays, scalars, spec, changes


def reference_call_args(arrays, scalars, device, spec=False, **changes):
    """The positional arguments of gi.reference_ray_resolve (and its plain
    version) for `arrays` on `device`: the diffuse ray's parameters of
    RenderConfig, or with spec the specular ray's (per-lane foggyness from
    the roughness unless gi_specular_foggyness_is_roughness is False: 0.9);
    `changes` are RenderConfig fields (gi_screen_trace_steps, ...)."""
    from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    t = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    cfg = RenderConfig(lightgrid_size=arrays["grid"].shape[0], lightgrid_extent=EXTENT,
                       bloom_pass_count=scalars["levels"], **changes)
    if spec:
        rp = gi.reference_ray_params(cfg, cfg.gi_specular_steps, cfg.gi_specular_step_scale,
                                     cfg.gi_specular_ss_intensity, scalars["prev_h"],
                                     scalars["prev_w"])
        fog = t["roughness"] if cfg.gi_specular_foggyness_is_roughness else 0.9
    else:
        rp = gi.reference_ray_params(cfg, cfg.gi_diffuse_steps, cfg.gi_diffuse_step_scale,
                                     cfg.gi_diffuse_ss_intensity, scalars["prev_h"],
                                     scalars["prev_w"])
        fog = cfg.gi_diffuse_foggyness
    return (gi.quantize_grid_u8(t["grid"]), t["depth"], t["atlas"].to(torch.bfloat16),
            t["view_from_world"], t["clip_from_view"], t["view_from_clip"],
            t["world_from_view"], t["vd"], t["pv"], t["pw"], t["rd"], t["noise"], fog, rp)


def set_call_args(name, device):
    """reference_call_args of the seeded set `name` on `device`."""
    arrays, scalars, spec, changes = set_arrays(name)
    return reference_call_args(arrays, scalars, device, spec=spec, **changes)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions on one CPU thread while this module runs: their
    bits do not depend on the thread count (math3d.sqrt, cpu_serial), and
    on a loaded machine PyTorch's thread pool made these small ops ~20x
    slower and their times erratic."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_reference_sets_cover_every_outcome():
    """Through the plain version on the CPU: every set ends lanes in each
    status, between them crossings re-arm (taps beyond the resolved lanes'),
    lanes open no voxel, both fog forms occur and a budget is below 24."""
    from vulkan_pbr_renderer_tpu_torch.shade import gi

    fogs, no_open, short = set(), 0, False
    for name, *_ in SETS:
        args = set_call_args(name, "cpu")
        work = {}
        rgb, status = gi.reference_ray_resolve_plain(*args, work=work)
        counts = {int(k): int(v) for k, v in zip(*np.unique(status.numpy(), return_counts=True))}
        assert set(counts) == {1, 2, 3} and min(counts.values()) >= 20, (name, counts)
        assert int(work["crossing"].sum()) > counts[3], name   # translucent crossings boosted
        no_open += int(((status == 2) & (work["seed"] == 0)).sum())
        fogs.add("lane" if hasattr(args[12], "shape") else "scalar")
        short |= args[13].max_ss_steps < 24
    assert no_open > 0 and fogs == {"lane", "scalar"} and short
