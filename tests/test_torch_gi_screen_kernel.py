"""The kernels of the fast GI's probe and hi-z screen terms and of its
economy mode (csrc/gi_screen_ray.cu: gi_screen_ray, gi_probe_ray) against
their plain version gi.screen_ray_resolve_plain on the card: every seeded
set of tests/test_torch_gi_screen_inputs.py (each knob branch), ragged lane
grids, one launch a call with fresh outputs, the refusals on the card and
the kernels' occupancy.  On the CPU too: the launch plans' shape
comparison and output layout (gi._ScreenPlan and gi._RefPlan, both on
gi._RayPlan), and the bytes chip_smoke.py's bound counts for a screen
kernel.

Tolerance: bit for bit (statuses equal, rgb's f32 bits equal): the kernels
follow the plain version's order on the card.

The kernel cases need a CUDA device and skip without one.  The file
imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gi_screen_kernel.py -q
"""

import numpy as np
import pytest
import torch

from test_torch_gi_screen_inputs import SETS, screen_call_args, screen_rays, set_call_args
from test_torch_gi_screen_inputs import wrapper_call
from vulkan_pbr_renderer_tpu_torch.shade import gi

CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_vs_plain(args):
    fn = gi.probe_ray_resolve if args[-1].kind == "fast" else gi.screen_ray_resolve
    before = fn.launches
    rgb_k, st_k = wrapper_call(args)
    assert fn.launches == before + 1
    rgb_p, st_p = gi.screen_ray_resolve_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(st_k, st_p, rtol=0, atol=0)
    torch.testing.assert_close(rgb_k.view(torch.int32), rgb_p.view(torch.int32), rtol=0, atol=0)
    return rgb_k, st_k


@pytest.mark.cuda
@pytest.mark.parametrize("name", [s[0] for s in SETS])
def test_screen_kernels_match_plain(cuda, name):
    _, st = _kernel_vs_plain(set_call_args(name, cuda))
    assert int((st == 3).sum()) > 0 or name == "economy_no_screen"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7, 143), (1, 1), (3, 1000), (2, 5, 33), (0,)])
@pytest.mark.parametrize("name", ["probes_knobs", "hiz", "economy_mip"])
def test_screen_kernels_ragged_lane_grids(cuda, shape, name):
    n = int(np.prod(shape))
    arrays, scalars = screen_rays(71, n=max(n, 1))
    for k in ("pw", "rd", "noise", "roughness"):
        arrays[k] = arrays[k][:n].reshape(shape + arrays[k].shape[1:])
    _, kind, spec, changes = next(s for s in SETS if s[0] == name)
    rgb, st = _kernel_vs_plain(screen_call_args(arrays, scalars, cuda, kind, spec, **changes))
    assert st.shape == shape and rgb.shape == shape + (3,)


@pytest.mark.cuda
def test_screen_kernel_fresh_outputs(cuda):
    args = set_call_args("hiz", cuda, n=512)
    a, _ = gi.screen_ray_resolve(*args)
    b, _ = gi.screen_ray_resolve(*args)
    assert a.data_ptr() != b.data_ptr()
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_screen_kernels_refuse_on_card(cuda):
    args = list(set_call_args("probes", cuda, n=64))
    with pytest.raises(ValueError, match="wave-9 march has no kernel"):
        gi.screen_ray_resolve(*args[:-1], args[-1]._replace(kind="march"))
    with pytest.raises(ValueError, match="must be contiguous"):
        gi.screen_ray_resolve(*args[:8], args[8].t().contiguous().t(), *args[9:])
    with pytest.raises(ValueError, match="on cuda"):
        gi.screen_ray_resolve(args[0].cpu(), *args[1:])
    ray = list(set_call_args("probes", cuda, n=64))
    ray[-1] = gi.ray_params(gi_cfg(), 12, 0.5, 0.75, 24, 32)._replace(fog_march=False)
    with pytest.raises(ValueError, match="wave-9 march"):
        gi.fast_ray_resolve(ray[0], None, ray[2], ray[3], ray[6], ray[6], ray[6], ray[7],
                            ray[8], ray[9], ray[8], ray[10], 0.5, ray[-1])


def gi_cfg():
    from vulkan_pbr_renderer_tpu_torch.config import RenderConfig

    return RenderConfig(lightgrid_size=16, bloom_pass_count=5)


@pytest.mark.cuda
def test_screen_kernels_occupancy(cuda):
    for which in ("probe", "probes", "hiz"):
        occ = gi.screen_ray_occupancy(which)
        assert occ["threads"] == 128 and occ["blocks_per_sm"] >= 1 and occ["registers"] > 0


def _screen_plan_inputs(args):
    """(plan key, the inputs in run_screen_ray's order, foggyness) of the
    plain version's arguments `args` on the CPU, as the wrappers pass them."""
    table, fgrid, depth, atlas, *mats, pw, rd, noise, fog, rp = args
    fn = "screen_ray_resolve"
    if rp.kind == "fast":
        fn, mats, noise, fog = "probe_ray_resolve", [mats[0], None, None, None], None, None
    screen, fog_lane = rp.term is not None, torch.is_tensor(fog)
    key = (fn, CPU, 0, tuple(pw.shape), tuple(table.shape),
           tuple(depth.shape) if screen else None, tuple(atlas.shape) if screen else None, rp,
           fgrid is not None, fog_lane)
    return key, [table, fgrid, depth, atlas, *mats, pw, rd, noise,
                 fog if fog_lane else None], fog


def _fresh_outputs(plan, lanes):
    a, b = plan.outputs(), plan.outputs()
    assert a[0].shape == (lanes, 3) and a[1].shape == (lanes,) and a[1].dtype == torch.int32
    base = a[0].untyped_storage().data_ptr()
    assert a[1].untyped_storage().data_ptr() == base and (a[1].data_ptr() - base) % 128 == 0
    assert b[0].untyped_storage().data_ptr() != base


@pytest.mark.parametrize("name", ["probes_knobs", "hiz_nearest", "economy"])
def test_screen_plan_reuse_accepts_and_fresh_outputs(name):
    key, ts, fog = _screen_plan_inputs(set_call_args(name, CPU, n=96))
    plan = gi._screen_plan(*key)
    assert gi._screen_plan(*key) is plan
    assert gi._screen_plan(*key[:2], 1, *key[3:]) is not plan       # another stream
    assert plan.accepts(ts, fog)
    pw, rd = ts[8], ts[9]
    none_slot = next(i for i, spec in enumerate(plan.specs) if spec == "none")
    bad = [ts[:8] + [pw.double()] + ts[9:],                         # dtype
           ts[:8] + [pw[:-1]] + ts[9:],                             # shape
           ts[:9] + [rd.t().contiguous().t()] + ts[10:],            # layout
           ts[:4] + [ts[4].to("meta")] + ts[5:],                    # device
           ts[:none_slot] + [pw] + ts[none_slot + 1:],              # a tensor for None
           ts[:-1]]                                                 # too few
    assert not any(plan.accepts(b, fog) for b in bad)
    if plan.specs[-1] == "none":                                    # a scalar foggyness
        assert not plan.accepts(ts, "0.5")
    _fresh_outputs(plan, 96)


def test_reference_plan_reuse_accepts_and_fresh_outputs():
    from test_torch_reference_ray_inputs import set_call_args as reference_call_args

    *ts, fog, rp = reference_call_args("specular", CPU)
    ts.append(fog)
    shapes = tuple(ts[9].shape), tuple(ts[0].shape), tuple(ts[1].shape), tuple(ts[2].shape)
    plan = gi._ref_plan(CPU, *shapes, rp, True)
    assert gi._ref_plan(CPU, *shapes, rp, True) is plan
    assert gi._ref_plan(CPU, *shapes, rp, False) is not plan        # a scalar foggyness
    assert plan.accepts(ts, fog)
    bad = [ts[:1] + [ts[1].double()] + ts[2:],                      # dtype
           ts[:9] + [ts[9][:-1]] + ts[10:],                         # shape
           ts[:3] + [ts[3].t()] + ts[4:],                           # layout
           ts[:-1]]                                                 # no foggyness lane
    assert not any(plan.accepts(b, fog) for b in bad)
    scalar = gi._ref_plan(CPU, *shapes, rp, False)
    assert scalar.accepts(ts[:-1], 0.9) and not scalar.accepts(ts[:-1], fog)
    _fresh_outputs(plan, ts[9].shape[0])


@pytest.mark.parametrize("name", ["probes", "probes_knobs", "hiz", "economy_no_screen"])
def test_chip_smoke_counts_the_pyramid_texels_read(name):
    """chip_smoke.py's bound counts the bf16 pyramid's probe level only
    (every level with dist_mip > 0) and the hi-z atlas's levels, not their
    unused texels."""
    import chip_smoke

    args = set_call_args(name, CPU, n=64)
    table, fgrid, depth, atlas, *mats, pw, rd, noise, fog, rp = args
    whole = [table, fgrid, *mats, pw, rd, noise, fog]
    want = sum(t.numel() * t.element_size() for t in whole if torch.is_tensor(t)) + 16 * 64
    if rp.term == "hiz":
        # a level with no texel: the walk's clamped cell reads one unused texel
        want += 4 * sum(max(rp.hiz_h >> lv, 1) * max(rp.hiz_w >> lv, 1) for lv in range(6))
    elif rp.term is not None:
        want += depth.numel() * 4
    if rp.term is not None:
        levels = range(rp.prev_levels) if rp.dist_mip > 0 else [rp.probe_level]
        want += 6 * sum((rp.prev_h >> lv) * (rp.prev_w >> lv) for lv in levels)
        assert want < sum(t.numel() * t.element_size() for t in whole + [depth, atlas]
                          if torch.is_tensor(t)) + 16 * 64
    assert chip_smoke._screen_work(args, {})[1] == want
