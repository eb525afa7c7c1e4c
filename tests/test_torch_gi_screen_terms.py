"""The fast GI's other marches and screen terms (shade/gi.py section 5) and
sampling.sample_screen_atlas_window against the JAX package, function by
function, on the seeded lanes of tests/test_torch_gi_screen_inputs.py (one
shape, 2,048 lanes, a 16^3 grid, a 48x64 depth, a 5-level pyramid); JAX
runs op by op on the CPU, one reference per case (functools.cache).

Tolerances: hit, off-screen and status masks equal; build_hiz_atlas bit
for bit; rgb, t and sample values within atol 1e-5 (the packages round
some divisions differently: PyTorch multiplies by a Python divisor's
reciprocal on the card and takes a tensor's reciprocal times a Python
numerator; the square roots and the tone compressor agree to an ulp).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gi_screen_inputs import _one_thread  # noqa: F401 (the module's fixture)
from test_torch_gi_screen_inputs import NEAR, FAR, screen_rays
from vulkan_pbr_renderer_tpu.gpu import sampling as js
from vulkan_pbr_renderer_tpu.shade import gi as jgi
from vulkan_pbr_renderer_tpu_torch.gpu import sampling as ts
from vulkan_pbr_renderer_tpu_torch.shade import gi as tgi

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@functools.cache
def _inputs():
    """The seeded lanes (seed 70) as numpy, with the segment ends the marches
    and probes take: ro = pw * scale in grid NDC and an open point 0.5-6
    voxels along the ray."""
    arrays, scalars = screen_rays(70)
    rng = np.random.default_rng(7)
    scale = scalars["lightgrid_scale"]
    ro = (arrays["pw"] * np.float32(scale)).astype(np.float32)
    k = rng.uniform(0.5, 6.0, ro.shape[:1]).astype(np.float32)[:, None]
    open_ = (ro + arrays["rd"] * np.float32(2.0 / 16) * k).astype(np.float32)
    return arrays, scalars, ro, open_


def _tables():
    arrays = _inputs()[0]
    return (tgi.quantize_grid_u8(_t(arrays["grid"])), jgi.pack_grid_u8(jnp.asarray(arrays["grid"])),
            jgi.pack_grid_alpha_u16(jnp.asarray(arrays["grid"])))


def _prev(level=None):
    """(port f16 pack, JAX f16 pack, (h, w)) of the pyramid: its level
    `level`, or the whole atlas."""
    arrays, scalars = _inputs()[:2]
    atlas = arrays["atlas"]
    ph, pwid = scalars["prev_h"], scalars["prev_w"]
    if level is None:
        sub, hw = atlas, (ph, pwid)
    else:
        offs, _ = js.mip_offsets(ph, pwid, scalars["levels"])
        hw = (ph >> level, pwid >> level)
        sub = atlas[:hw[0], offs[level]:offs[level] + hw[1]]
    tpack = ts.window_pack(_t(sub).to(torch.bfloat16), 2, 2, dtype=torch.float16)
    jpack = js.window_pack(jnp.asarray(sub).astype(jnp.bfloat16), 2, 2, dtype=jnp.float16)
    return tpack, jpack, hw


def test_sample_screen_atlas_window_matches_jax():
    """Per-lane levels (out-of-range ones clamp) and uv inside and off the
    atlas, from the whole pyramid's f16 pack."""
    arrays, scalars = _inputs()[:2]
    rng = np.random.default_rng(3)
    uv = rng.uniform(-0.2, 1.2, (2048, 2)).astype(np.float32)
    lv = rng.integers(-1, scalars["levels"] + 2, 2048).astype(np.int32)
    tpack, jpack, (ph, pwid) = _prev()
    _eq(tpack.to(torch.float32).numpy(), np.asarray(jpack, np.float32))
    got = ts.sample_screen_atlas_window(tpack, ph, pwid, scalars["levels"], _t(uv), _t(lv), 3)
    want = js.sample_screen_atlas_window(jpack, ph, pwid, scalars["levels"], jnp.asarray(uv),
                                         jnp.asarray(lv), 3)
    _close(got.numpy(), want)


@pytest.mark.parametrize("dist,n_samples,spread", [(2.5, 2, 3.0), (4.0, 1, 3.5), (2.5, 3, 2.0)])
def test_sample_radiance_fast_matches_jax(dist, n_samples, spread):
    arrays, scalars = _inputs()[:2]
    table, jgrid, jalpha = _tables()
    kw = dict(dist_voxels=dist, skip_steps=4, open_thresh=0.3, n_samples=n_samples,
              sample_spread=spread)
    rgb, ro = tgi.sample_radiance_fast(table, _t(arrays["pw"]), _t(arrays["rd"]),
                                       scalars["lightgrid_scale"], alpha_grid=table, **kw)
    jrgb, jro = jgi.sample_radiance_fast(jgrid, jnp.asarray(arrays["pw"]),
                                         jnp.asarray(arrays["rd"]), scalars["lightgrid_scale"],
                                         alpha_grid=jalpha, **kw)
    _eq(ro.numpy(), jro)
    _close(rgb.numpy(), jrgb)
    assert float(rgb.abs().max()) > 0.1


@pytest.mark.parametrize("steps", [3, 6])
def test_march_to_hit_matches_jax(steps):
    arrays = _inputs()[0]
    ro, open_ = _inputs()[2:]
    table, _, jalpha = _tables()
    rd = arrays["rd"] * np.float32(0.125)
    got_ro, got_hit = tgi.march_to_hit(table, _t(open_), _t(rd), steps)
    want_ro, want_hit = jgi.march_to_hit(jalpha, jnp.asarray(open_), jnp.asarray(rd), steps)
    _eq(got_hit.numpy(), want_hit)
    _eq(got_ro.numpy(), want_ro)
    assert 0 < int(got_hit.sum()) < len(rd)


@pytest.mark.parametrize("noise,rgb_samples", [(True, 2), (False, 3), (True, 1)])
def test_sample_radiance_march_matches_jax(noise, rgb_samples):
    arrays, scalars = _inputs()[:2]
    table, jgrid, jalpha = _tables()
    kw = dict(skip_steps=4, open_thresh=0.3, hit_steps=12, step_scale=0.5,
              rgb_samples=rgb_samples)
    got = tgi.sample_radiance_march(table, table, _t(arrays["pw"]), _t(arrays["rd"]),
                                    scalars["lightgrid_scale"],
                                    noise=_t(arrays["noise"]) if noise else None, **kw)
    want = jgi.sample_radiance_march(jgrid, jalpha, jnp.asarray(arrays["pw"]),
                                     jnp.asarray(arrays["rd"]), scalars["lightgrid_scale"],
                                     noise=jnp.asarray(arrays["noise"]) if noise else None, **kw)
    _close(got[0].numpy(), want[0])
    for g, w in zip(got[1:3], want[1:3]):
        _close(g.numpy(), w)
    for g, w in zip(got[3:], want[3:]):
        _eq(g.numpy(), w)
    assert 0 < int(got[3].sum()) < len(arrays["pw"])


def test_screen_probe_matches_jax():
    arrays, scalars, _, open_ = _inputs()
    tpack, jpack, hw = _prev(1)
    hit, rgb = tgi.screen_probe(_t(open_), scalars["lightgrid_scale"],
                                _t(arrays["clip_from_world"]), _t(arrays["depth"]), tpack, hw,
                                0.75, z_margin=5e-5)
    jhit, jrgb = jgi.screen_probe(jnp.asarray(open_), scalars["lightgrid_scale"],
                                  jnp.asarray(arrays["clip_from_world"]),
                                  jnp.asarray(arrays["depth"]), jpack, hw, 0.75, z_margin=5e-5)
    _eq(hit.numpy(), jhit)
    _close(rgb.numpy(), jrgb)
    assert 50 < int(hit.sum()) < len(open_) - 50


# (name, screen_probe_multi keywords, whole pyramid): every knob branch
MULTI_CASES = [
    ("defaults", dict(k_points=5), False),
    ("growth_jitter_offscreen", dict(k_points=5, spacing_growth=1.3, point_jitter=0.5,
                                     want_offscreen=True), False),
    ("gamma_taps", dict(k_points=4, spacing_gamma=2.0, solid_taps=3, want_offscreen=True),
     False),
    ("mip_taps", dict(k_points=5, solid_taps=2, dist_mip=0.4, want_offscreen=True), True),
    ("mip", dict(k_points=3, dist_mip=0.6), True),
]


@functools.cache
def _jax_multi(name):
    arrays, scalars, ro, open_ = _inputs()
    kw, whole = next((k, w) for n, k, w in MULTI_CASES if n == name)
    _, jpack, hw = _prev(None if whole else 1)
    _, _, jalpha = _tables()
    if whole:
        kw = dict(kw, prev_levels=scalars["levels"])
    out = jgi.screen_probe_multi(
        jnp.asarray(ro), jnp.asarray(open_ * np.float32(1.5) - ro * np.float32(0.5)),
        scalars["lightgrid_scale"], jnp.asarray(arrays["clip_from_world"]),
        jnp.asarray(arrays["depth"]), jpack, hw, 0.9, z_margin=5e-5, alpha_grid=jalpha,
        world_from_clip=jnp.asarray(arrays["world_from_clip"]),
        noise=jnp.asarray(arrays["noise"]), **kw)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("name", [c[0] for c in MULTI_CASES])
def test_screen_probe_multi_matches_jax(name):
    arrays, scalars, ro, open_ = _inputs()
    kw, whole = next((k, w) for n, k, w in MULTI_CASES if n == name)
    tpack, _, hw = _prev(None if whole else 1)
    table = _tables()[0]
    if whole:
        kw = dict(kw, prev_levels=scalars["levels"])
    got = tgi.screen_probe_multi(
        _t(ro), _t(open_ * np.float32(1.5) - ro * np.float32(0.5)), scalars["lightgrid_scale"],
        _t(arrays["clip_from_world"]), _t(arrays["depth"]), tpack, hw, 0.9, z_margin=5e-5,
        alpha_grid=table, world_from_clip=_t(arrays["world_from_clip"]),
        noise=_t(arrays["noise"]), **kw)
    want = _jax_multi(name)
    _eq(got[0].numpy(), want[0])
    hit = want[0]
    _close(got[1].numpy()[hit], want[1][hit])
    if kw.get("want_offscreen"):
        _eq(got[2].numpy(), want[2])
        assert int(got[2].sum()) > 20
    assert 20 < int(hit.sum()) < len(hit) - 20


@functools.cache
def _depth_half():
    arrays = _inputs()[0]
    d = arrays["depth"]
    return np.minimum.reduce([d[i::2, j::2] for i in (0, 1) for j in (0, 1)])


def test_build_hiz_atlas_matches_jax_exactly():
    """Six levels of 2 x 2 minima of the 24x32 depth (the last ones empty)
    and of the 48x64 one, bit for bit, offsets equal."""
    for depth in (_depth_half(), _inputs()[0]["depth"]):
        atlas, offs = tgi.build_hiz_atlas(_t(depth), 6)
        jatlas, joffs = jgi.build_hiz_atlas(jnp.asarray(depth), 6)
        _eq(atlas.numpy().view(np.uint32), np.asarray(jatlas).view(np.uint32))
        _eq(offs.numpy(), joffs)


@functools.cache
def _hiz_points(seed):
    """Segments on and off screen: p0 = (u, v, z) on the depth's range, p1
    up to 0.5 of the screen away."""
    rng = np.random.default_rng(seed)
    p0 = np.stack([rng.uniform(0.05, 0.95, 2048), rng.uniform(0.05, 0.95, 2048),
                   rng.uniform(0.94, 0.999, 2048)], -1).astype(np.float32)
    p1 = (p0 + np.stack([rng.uniform(-0.5, 0.5, 2048), rng.uniform(-0.5, 0.5, 2048),
                         rng.uniform(-0.02, 0.05, 2048)], -1)).astype(np.float32)
    return p0, p1


@pytest.mark.parametrize("zview", [True, False])
def test_hiz_trace_matches_jax(zview):
    depth = _depth_half()
    atlas, offs = tgi.build_hiz_atlas(_t(depth), 6)
    jatlas, joffs = jgi.build_hiz_atlas(jnp.asarray(depth), 6)
    p0, p1 = _hiz_points(5)
    kw = dict(iters=14, thickness=0.75 if zview else 0.015, z_bias=0.05 if zview else 2e-4,
              zview_nf=(NEAR, FAR) if zview else None)
    hit, t_hit, dead = tgi.hiz_trace(atlas, offs, depth.shape, _t(p0), _t(p1), **kw)
    jhit, jt, jdead = jgi.hiz_trace(jatlas, joffs, depth.shape, jnp.asarray(p0),
                                    jnp.asarray(p1), **kw)
    _eq(hit.numpy(), jhit)
    _eq(dead.numpy(), jdead)
    _close(t_hit.numpy(), jt)
    assert 20 < int(hit.sum()) < len(p0) - 20 and int(dead.sum()) > 20


@pytest.mark.parametrize("solid", [0.0, 0.2])
def test_screen_trace_hiz_matches_jax(solid):
    arrays, scalars, ro, open_ = _inputs()
    depth = _depth_half()
    atlas, offs = tgi.build_hiz_atlas(_t(depth), 6)
    jatlas, joffs = jgi.build_hiz_atlas(jnp.asarray(depth), 6)
    tpack, jpack, hw = _prev(1)
    table, _, jalpha = _tables()
    end = open_ * np.float32(3.0) - ro * np.float32(2.0)
    kw = dict(iters=14, thickness=0.75, z_bias=0.05, solid_thresh=solid, zview_nf=(NEAR, FAR))
    hit, rgb = tgi.screen_trace_hiz(_t(ro), _t(end), scalars["lightgrid_scale"],
                                    _t(arrays["clip_from_world"]), atlas, offs, depth.shape,
                                    tpack, hw, 0.9, alpha_grid=table, **kw)
    jhit, jrgb = jgi.screen_trace_hiz(jnp.asarray(ro), jnp.asarray(end),
                                      scalars["lightgrid_scale"],
                                      jnp.asarray(arrays["clip_from_world"]), jatlas, joffs,
                                      depth.shape, jpack, hw, 0.9, alpha_grid=jalpha, **kw)
    _eq(hit.numpy(), jhit)
    h = np.asarray(jhit)
    _close(rgb.numpy()[h], np.asarray(jrgb)[h])
    assert 20 < int(hit.sum()) < len(h) - 20
