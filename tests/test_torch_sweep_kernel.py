"""The lightgrid sweep's one-launch entry point (shade/gi.py
sweep_lightgrid_u8; csrc/sweep.cu on the card) and the GI lane inputs'
cached plan (shade/gi_modes.py _LanePlan), on the CPU:
  - sweep_lightgrid_u8's CPU route against the JAX package's
    sweep_lightgrid exactly and its table against the corners of JAX's
    pack_grid_u8, on every axis, on test_sweep_matches_glsl_semantics's
    (32,4,4,4) grid, 16^3 and a grid of odd swept lengths, with no voxel,
    every voxel and ~30% of the voxels occupied;
  - sweep_schedule, the combines the kernel walks: replayed in numpy they
    give _linrec_scan's bits for every n from 1 to 130, its levels disjoint;
  - the kernel's steps modelled in numpy (the schedule forward, the forward
    result folded into the backward scan's inputs, the schedule mirrored,
    the blend and the quantize) give sweep_lightgrid_u8's bits;
  - sweep_rotated's grid and table, read by gi_pass through
    LightingResources.lightgrid_u8, against the JAX frame (within
    test_torch_gi_pass.py's tolerance); gi_pass without the table raises;
  - _LanePlan: a plan per shape and stream, reused; what `accepts` refuses;
    fresh outputs a call, views of one allocation on 128-byte lines.
The kernels run on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gi_pass import (JCFG, _globals, _jax_gi_inputs, _mostly_close, _port_cfg,
                                _sub_inputs)
from vulkan_pbr_renderer_tpu.app import renderer as jr
from vulkan_pbr_renderer_tpu.shade import gi as jgi
from vulkan_pbr_renderer_tpu.shade import gi_modes as jgm
from vulkan_pbr_renderer_tpu.shade import lighting as jlight
from vulkan_pbr_renderer_tpu_torch.app import renderer as tr
from vulkan_pbr_renderer_tpu_torch.shade import gbuffer as tgb
from vulkan_pbr_renderer_tpu_torch.shade import gi as tgi
from vulkan_pbr_renderer_tpu_torch.shade import gi_modes as tgm
from vulkan_pbr_renderer_tpu_torch.shade import lighting as tlight

SKY, MOVE_RATIO, BLEND = (1.0, 1.2, 2.0), 0.5, 0.35


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _eq(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _grids(axis, occupied):
    """test_sweep_matches_glsl_semantics's grid (32 along `axis`), 16^3 and
    a 7x9x5 grid, with `occupied` of the voxels occupied (0, 0.3 or 1)."""
    rng = np.random.default_rng(7 + axis)
    g = rng.uniform(0, 2, (32, 4, 4, 4)).astype(np.float32)
    grids = [np.ascontiguousarray(np.moveaxis(g, 0, axis)),
             rng.uniform(0, 3, (16, 16, 16, 4)).astype(np.float32),
             rng.uniform(0, 3, (7, 9, 5, 4)).astype(np.float32)]
    for g in grids:
        g[..., 3] = rng.random(g.shape[:3]) < occupied
    return grids


@pytest.mark.parametrize("occupied", [0.0, 0.3, 1.0], ids=["empty", "30pct", "full"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sweep_u8_cpu_matches_jax(axis, occupied):
    for g in _grids(axis, occupied):
        out, table = tgi.sweep_lightgrid_u8(_t(g), axis, SKY, MOVE_RATIO, BLEND)
        want = jgi.sweep_lightgrid(jnp.asarray(g), axis=axis)
        _eq(out, want)
        assert table.dtype == torch.uint8 and table.shape == g.shape
        _eq(table, np.asarray(jgi.pack_grid_u8(want))[..., :4])
        _eq(table, tgi.quantize_grid_u8(out))


def _replay(a, b, levels, mirror=False):
    """The schedule's combines in numpy f32, each a rounded product and a
    rounded sum, along axis 0 (positions mirrored for the backward scan)."""
    a, b, n = a.copy(), b.copy(), a.shape[0]
    for lv in levels:
        s, d = (n - 1 - lv[:, 0], n - 1 - lv[:, 1]) if mirror else (lv[:, 0], lv[:, 1])
        a[d], b[d] = a[s] * a[d], a[d] * b[s] + b[d]
    return a, b


def test_schedule_replays_linrec_scan():
    """For every n from 1 to 130, with a of the sweep (0 or 0.5) and with
    arbitrary a (inexact products): the replayed schedule equals
    _linrec_scan bit for bit; no level reads a position it writes."""
    rng = np.random.default_rng(3)
    for n in range(1, 131):
        levels = tgi.sweep_schedule(n)
        for lv in levels:
            assert not set(lv[:, 0].tolist()) & set(lv[:, 1].tolist())
            assert len(set(lv[:, 1].tolist())) == len(lv)
        for a in (np.where(rng.random((n, 1)) < 0.3, 0.0, 0.5).astype(np.float32),
                  rng.uniform(0.1, 1.3, (n, 1)).astype(np.float32)):
            b = rng.uniform(0, 3, (n, 3)).astype(np.float32)
            want_a, want_b = tgi._linrec_scan(_t(a), _t(b))
            got_a, got_b = _replay(a, b, levels)
            _eq(got_a, want_a)
            _eq(got_b, want_b)
    assert [len(tgi.sweep_schedule(n)) for n in (1, 2, 3, 128)] == [0, 1, 2, 13]


def _kernel_model(grid, axis):
    """csrc/sweep.cu's steps in numpy f32 on lines along `axis`."""
    f32 = np.float32
    mr, keep, blend = f32(MOVE_RATIO), f32((1 - MOVE_RATIO) / MOVE_RATIO), f32(BLEND)
    sky = np.asarray(SKY, np.float32)
    g = np.moveaxis(grid, axis, 0)
    n = g.shape[0]
    old = g[..., :3]
    occ = (g[..., 3] > f32(0.5))[..., None]
    a = np.where(occ, f32(0), mr).astype(np.float32)
    levels = tgi.sweep_schedule(n)
    A, B = _replay(a, np.where(occ, old, mr * old), levels)
    L = A * sky + B
    f = keep * L
    f[-1] = f[-1] + L[-1]
    A, B = _replay(a, np.where(occ, old, mr * f), levels, mirror=True)
    L = A * sky + B
    bwd = keep * L
    bwd[0] = bwd[0] + L[0]
    rgb = np.where(occ, old, old + (bwd - old) * blend)
    out = np.moveaxis(np.concatenate([rgb, g[..., 3:]], -1), 0, axis)
    x = np.maximum(out[..., :3], f32(0))
    q = np.concatenate([np.sqrt(x / (f32(1) + x)), out[..., 3:]], -1)
    return out, np.clip(np.rint(q * f32(255)), 0, 254).astype(np.uint8)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_kernel_model_matches_plain(axis):
    for g in _grids(axis, 0.3) + _grids(axis, 0.0)[1:2]:
        out, table = tgi.sweep_lightgrid_u8(_t(g), axis, SKY, MOVE_RATIO, BLEND)
        m_out, m_table = _kernel_model(g, axis)
        _eq(m_out, out)
        _eq(m_table, table)


def test_sweep_rotated_table_through_gi_pass():
    """Frame 4's sweep of test_torch_gi_pass.py's grid (the y axis) in both
    packages, and gi_pass on the port's grid and table against JAX's
    gi_pass on its grid; without the table gi_pass raises."""
    cam, fi, _, gbuf, grid, prev, cache = _jax_gi_inputs()
    jcfg = JCFG
    cfg = _port_cfg(jcfg)
    swept, table = tr.sweep_rotated(_t(grid), 4, cfg)
    jgrid = jr.sweep_rotated(grid, jnp.int32(4), jcfg)
    np.testing.assert_allclose(swept.numpy(), np.asarray(jgrid), rtol=0, atol=1e-6)
    _eq(table, tgi.quantize_grid_u8(swept))
    jres = jlight.LightingResources(sun_depth=None, lightgrid=jgrid, prefiltered_env=None,
                                    brdf_lut=None,
                                    prev_frame_atlas=jnp.asarray(prev).astype(jnp.bfloat16))
    jglob = _globals(cam, fi, 3.0, False)
    want = jgm.gi_pass(jcfg, jglob, jres, _sub_inputs(gbuf, jglob), gbuf.depth, 64, 96,
                       jglob.frame_idx_mod_59, gi_cache=jnp.asarray(cache),
                       frame_idx=jnp.int32(4))
    tgbuf = tgb.GBuffer(*map(_t, gbuf))
    res = tlight.LightingResources(sun_depth=None, prefiltered_env=None, brdf_lut=None,
                                   lightgrid=swept, lightgrid_u8=table,
                                   prev_frame_atlas=_t(prev).to(torch.bfloat16))
    tglob = _globals(cam, fi, 3.0, True)
    got = tgm.gi_pass(cfg, tglob, res, tgbuf, tgbuf.depth, 64, 96, 3.0, gi_cache=_t(cache),
                      frame_idx=4)
    for g, w in zip(got, want):
        _mostly_close(g.numpy(), w)
    with pytest.raises(ValueError, match="lightgrid_u8"):
        tgm.gi_pass(cfg, tglob, res._replace(lightgrid_u8=None), tgbuf, tgbuf.depth, 64, 96,
                    3.0, gi_cache=_t(cache), frame_idx=4)


def test_lane_plan_reuse_accepts_and_fresh_outputs():
    cpu = torch.device("cpu")
    plan = tgm._lane_plan(cpu, 0, 48, 64, 2, 0, 48, "checker", True)
    assert tgm._lane_plan(cpu, 0, 48, 64, 2, 0, 48, "checker", True) is plan
    for key in ((cpu, 1, 48, 64, 2, 0, 48, "checker", True),       # another stream
                (cpu, 0, 48, 64, 2, 8, 96, "checker", True),       # a band
                (cpu, 0, 48, 64, 2, 0, 48, "columns", True),
                (cpu, 0, 48, 64, 4, 0, 48, None, False)):
        assert tgm._lane_plan(*key) is not plan
    ts = [torch.zeros(s) for s in plan.shapes]
    assert plan.accepts(ts)
    bad = [ts[:2] + [ts[2].double()] + ts[3:],                     # dtype
           ts[:1] + [torch.zeros((48, 63, 3))] + ts[2:],           # shape
           [torch.zeros((64, 48, 3)).transpose(0, 1)] + ts[1:],    # layout
           ts[:5] + [torch.zeros(6)[::2]],                         # a strided camera
           ts[:3] + [torch.zeros((4, 4), device="meta")] + ts[4:]]  # device
    assert not any(plan.accepts(b) for b in bad)
    a, b = plan.outputs(), plan.outputs()
    assert a.pw.shape == (24, 16, 3) and a.n3.shape == (24, 16) and a.rough.shape == (24, 16)
    assert a.pw.untyped_storage().data_ptr() != b.pw.untyped_storage().data_ptr()
    base = a.pw.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base and t.is_contiguous()
               and (t.data_ptr() - base) % 128 == 0 for t in a)
    diffuse = tgm._lane_plan(cpu, 0, 48, 64, 4, 0, 48, None, False).outputs()
    assert (diffuse.vd, diffuse.spec, diffuse.rough) == (None, None, None)
    assert diffuse.bent.shape == (12, 16, 3)
    with pytest.raises(ValueError, match="even lane grid"):
        tgm._lane_plan(cpu, 0, 48, 62, 2, 0, 48, "columns", True)
    with pytest.raises(ValueError, match="unknown pattern"):
        tgm._lane_plan(cpu, 0, 48, 64, 2, 0, 48, "rows", True)
