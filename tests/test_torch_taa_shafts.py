"""The plain versions behind the TAA kernel and the one-launch polar shafts
(csrc/post.cu taa_kernel, csrc/lighting.cu shafts_polar_kernel) against
the JAX package on the CPU, and their wrappers' CPU dispatch:
  - taa.taa_resolve_plain against JAX taa_resolve in the three history
    modes with velocities of sigma 0.2 uv (taps reprojected tens of
    texels away) and with part of the frame reprojected off screen;
  - shadow.shafts_polar_plain against the JAX sub_inputs composed with
    light_shafts_polar at n_r 48 (path A's) in a row band;
  - taa_resolve and shafts_polar on CPU tensors: their plain versions, bit
    for bit, no launch counted;
  - math3d.sqrt, the plain versions' square root, on the CPU: correctly
    rounded (torch.sqrt there runs MKL's vector math, whose first parallel
    call in a process has returned a thread's chunk at ~12-bit accuracy);
  - taa_resolve_plain at 272x480, in each mode, is the same bits with 1, 4
    and 8 intra-op threads, and when a fresh process makes its first call
    with 4 (a failure names the run, the mode and the first value that
    differs, and leaves both arrays in pytest's tmp_path).

Tolerance against JAX: f32 atol / rtol 1e-5, test_torch_shade.py's.  The
kernels run only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import inspect
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shade_inputs import frame_config, lighting_inputs, shade_scene
from vulkan_pbr_renderer_tpu.shade import lighting as jlight
from vulkan_pbr_renderer_tpu.shade import shadow as jshadow
from vulkan_pbr_renderer_tpu.shade import taa as jtaa
from vulkan_pbr_renderer_tpu.utils import noise as jnoise
from vulkan_pbr_renderer_tpu_torch.shade import lighting as tlight
from vulkan_pbr_renderer_tpu_torch.shade import shadow as tshadow
from vulkan_pbr_renderer_tpu_torch.shade import taa as ttaa
from vulkan_pbr_renderer_tpu_torch.utils import math3d as tm3

TAA_MODES = {"ycocg": dict(catmull_history=True), "full_rgb": dict(full_rgb_catmull=True),
             "bilinear": dict(catmull_history=False)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _taa_arrays(h, w, sigma, offscreen, seed=5):
    """lighting, depth, velocity, velocity_prev, history; offscreen: the
    left third of the rows' velocity x at 1.5 uv, so those pixels reproject
    past the frame's left edge."""
    rng = np.random.default_rng(seed)
    vel = rng.normal(0, sigma, (h, w, 2)).astype(np.float32)
    if offscreen:
        vel[:, : w // 3, 0] = 1.5
    return (rng.uniform(0, 4, (h, w, 3)).astype(np.float32),
            rng.uniform(0, 1, (h, w)).astype(np.float32), vel,
            rng.normal(0, sigma, (h, w, 2)).astype(np.float32),
            rng.uniform(0, 4, (h, w, 3)).astype(np.float32))


@pytest.mark.parametrize("mode", list(TAA_MODES))
@pytest.mark.parametrize("sigma,offscreen", [(0.2, False), (0.02, True)],
                         ids=["sigma0.2", "offscreen"])
def test_taa_plain_matches_jax_far_reprojection(mode, sigma, offscreen):
    arrs = _taa_arrays(24, 40, sigma, offscreen)
    kw = TAA_MODES[mode]
    got = ttaa.taa_resolve_plain(*map(torch.from_numpy, arrs), 0.05, 1000.0, **kw)
    want = jtaa.taa_resolve(*map(jnp.asarray, arrs), 0.05, 1000.0, **kw)
    _close(got, want)
    if offscreen:   # the off-screen pixels take the current frame alone
        src = ttaa.taa_resolve_plain(*map(torch.from_numpy, arrs), 1.0, 0.0, **kw)
        assert torch.equal(got[:, : 40 // 3 - 1], src[:, : 40 // 3 - 1])


def _jax_shaft_inputs(g, glob, k, f59, row_offset, fh):
    """The JAX lighting pass's sub_inputs at the [::k, ::k] grid: normal,
    world position, noise 1."""
    d = jnp.asarray(g.depth.numpy())[::k, ::k]
    hd, wd = d.shape
    pw, _ = jlight.reconstruct_positions(d, jnp.asarray(glob.world_from_clip.numpy()),
                                         jnp.asarray(glob.view_from_clip.numpy()), row_offset,
                                         fh, stride=k)
    px = jnp.broadcast_to(jnp.arange(wd, dtype=jnp.float32)[None, :] * k + 0.5, (hd, wd))
    py = jnp.broadcast_to(jnp.arange(hd, dtype=jnp.float32)[:, None] * k + row_offset + 0.5,
                          (hd, wd))
    return (jnp.asarray(g.normal.numpy())[::k, ::k], pw,
            jnoise.frame_noise(px, py, jnp.float32(f59)))


def test_shafts_plain_matches_jax_n_r_48_band():
    h, w = 48, 64
    g, glob, tables, kw = lighting_inputs(shade_scene("cpu"), h, w, band=(13, 21))
    em = tlight.sun_emission(frame_config(h, w))
    got = tshadow.shafts_polar_plain(
        tables["sun_depth"], glob.sun_from_world, glob.camera_pos, g.normal, g.depth,
        glob.world_from_clip, glob.view_from_clip, 4, 3.0, torch.as_tensor(em), max_steps=48,
        n_theta=4096, n_r=48, row_offset=kw["row_offset"], full_height=h)
    nd, pwd, n1d = _jax_shaft_inputs(g, glob, 4, 3.0, kw["row_offset"], h)
    want = jshadow.light_shafts_polar(jnp.asarray(tables["sun_depth"].numpy()),
                                      jnp.asarray(glob.sun_from_world.numpy()),
                                      jnp.asarray(glob.camera_pos.numpy()), pwd, nd, n1d,
                                      jnp.asarray(em), max_steps=48, n_theta=4096, n_r=48)
    assert got.shape == (6, 16, 3) and float(np.abs(np.asarray(want)).max()) > 0.0
    _close(got, want)


def test_wrappers_take_plain_versions_on_cpu():
    """taa_resolve and shafts_polar on CPU tensors: the plain versions bit
    for bit, no launch counted."""
    before = (ttaa.taa_resolve.launches, tshadow.shafts_polar.launches)
    ins = [torch.from_numpy(a) for a in _taa_arrays(20, 36, 0.2, True)]
    for kw in TAA_MODES.values():
        assert torch.equal(ttaa.taa_resolve(*ins, **kw), ttaa.taa_resolve_plain(*ins, **kw))
    h, w = 48, 64
    g, glob, tables, kw = lighting_inputs(shade_scene("cpu"), h, w, band=(13, 21))
    em = tlight.sun_emission(frame_config(h, w))
    args = (tables["sun_depth"], glob.sun_from_world, glob.camera_pos, g.normal, g.depth,
            glob.world_from_clip, glob.view_from_clip, 4, 3.0)
    skw = dict(max_steps=48, n_theta=4096, n_r=48, row_offset=kw["row_offset"], full_height=h)
    assert torch.equal(tshadow.shafts_polar(*args, em, **skw),
                       tshadow.shafts_polar_plain(*args, torch.as_tensor(em), **skw))
    assert (ttaa.taa_resolve.launches, tshadow.shafts_polar.launches) == before


def test_taa_sqrt_rounds_correctly_on_cpu():
    """The plain versions' square root (math3d.sqrt) on the CPU is the
    correctly rounded one (float64 sqrt rounded to float32 is), on a
    strided view and a 0-dim tensor too."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 8, (64, 96, 3)).astype(np.float32))
    for t in (x, x[:, ::2], x[5, 7, 1]):
        got = tm3.sqrt(t)
        want = np.sqrt(t.numpy().astype(np.float64)).astype(np.float32)
        assert got.dtype == torch.float32 and got.shape == t.shape
        assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


# a fresh process's first call: _taa_arrays' inputs, 4 threads from the start
_THREADS_SCRIPT = """
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from vulkan_pbr_renderer_tpu_torch.shade import taa
torch.set_num_threads(4)
{arrays}
ins = [torch.from_numpy(a) for a in _taa_arrays(272, 480, 0.2, False)]
np.save(sys.argv[2], taa.taa_resolve_plain(*ins, **{kw!r}).numpy())
"""


@pytest.mark.parametrize("mode", list(TAA_MODES))
def test_taa_plain_same_bits_across_threads(tmp_path, mode):
    """taa_resolve_plain at 272x480 with 1, 4 and 8 intra-op threads, and in
    a fresh process whose first call runs with 4: the same bits (ROADMAP
    queue 3 item 2).  A failure names the run, the first differing value
    and how many differ, and saves both arrays under tmp_path."""
    kw = TAA_MODES[mode]
    ins = [torch.from_numpy(a) for a in _taa_arrays(272, 480, 0.2, False)]
    threads = torch.get_num_threads()
    try:
        runs = {}
        for n in (1, 4, 8):
            torch.set_num_threads(n)
            runs[f"{n} thread{'s' * (n > 1)}"] = ttaa.taa_resolve_plain(*ins, **kw).numpy()
    finally:
        torch.set_num_threads(threads)
    out = tmp_path / "fresh.npy"
    script = _THREADS_SCRIPT.format(arrays=inspect.getsource(_taa_arrays), kw=kw)
    subprocess.run([sys.executable, "-c", script, REPO, str(out)], check=True, timeout=300)
    runs["a fresh process, 4 threads"] = np.load(out)
    want = runs["1 thread"]
    for name, got in runs.items():
        differ = got.view(np.int32) != want.view(np.int32)
        if differ.any():
            first = np.unravel_index(np.flatnonzero(differ)[0], differ.shape)
            saved = tmp_path / f"{mode}_{name.replace(' ', '_').replace(',', '')}.npz"
            np.savez(saved, got=got, want=want)
            pytest.fail(f"{mode}, {name}: {int(differ.sum())} values differ from 1 thread's; "
                        f"the first at (y, x, c) {tuple(int(i) for i in first)}: "
                        f"{got[first]!r} against {want[first]!r}; arrays in {saved}")
