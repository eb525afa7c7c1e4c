"""The post stack's plain versions (shade/taa.py, shade/bloom.py, the port's
app/renderer.py::post_stack) against the JAX package on the CPU, and the
dispatch of their wrappers on a CPU tensor.

  - TAA over a row window of full-height inputs: bit for bit the same rows
    of the whole-frame resolve, and JAX's rows within 1e-5, in the three
    history modes;
  - each bloom level (bloom_down_level / bloom_up_level) against JAX's
    downsample_13tap / upsample_tent9 on the same input, at 2:1 and odd
    chains (96x160, 135x240, 54x96, 64x64 down to 1x1), within 1e-5; the
    bf16 atlas the down levels write against JAX's
    pack_mip_atlas(...).astype(bfloat16) within bf16 rounding (and bit for
    bit against the port's own pack); the fused final level against JAX's
    gamma_encode(aces_approx(exposure * bloom)); row windows of a level bit
    for bit the same rows of the whole level;
  - post_stack against JAX's post_stack on frame 0 (history = hdr) and
    frame 1, within 1e-5, for enable_taa x enable_bloom.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.app import renderer as jr
from vulkan_pbr_renderer_tpu.config import RenderConfig as JaxConfig
from vulkan_pbr_renderer_tpu.gpu import sampling as jsamp
from vulkan_pbr_renderer_tpu.shade import bloom as jbloom
from vulkan_pbr_renderer_tpu.shade import taa as jtaa
from vulkan_pbr_renderer_tpu.utils import color as jcolor
from vulkan_pbr_renderer_tpu_torch.app import renderer as tr
from vulkan_pbr_renderer_tpu_torch.config import RenderConfig
from vulkan_pbr_renderer_tpu_torch.gpu import sampling as tsamp
from vulkan_pbr_renderer_tpu_torch.shade import bloom as tbloom
from vulkan_pbr_renderer_tpu_torch.shade import taa as ttaa

TAA_MODES = [(True, False), (True, True), (False, False)]
MODE_IDS = ["ycocg", "full_rgb", "bilinear"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _exact(got, want):
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _taa_inputs(h=24, w=40, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 4, (h, w, 3)).astype(np.float32),
            rng.uniform(0, 1, (h, w)).astype(np.float32),
            rng.normal(0, 0.01, (h, w, 2)).astype(np.float32),
            rng.normal(0, 0.01, (h, w, 2)).astype(np.float32),
            rng.uniform(0, 4, (h, w, 3)).astype(np.float32))


POST_SHAPE = (54, 96)      # bloom levels 27 -> 13 -> 6: odd sizes


@pytest.mark.parametrize("catmull,full_rgb", TAA_MODES, ids=MODE_IDS)
def test_taa_row_window_plain(catmull, full_rgb):
    """The row window at the top, inside and at the bottom of the frame:
    the whole-frame rows bit for bit, and the same rows of JAX's resolve
    (op by op, as post_stack runs it) within 1e-5.  JAX's halo resolve
    equals its whole-frame rows; tests/test_torch_rows.py::test_taa_band
    holds the port's halo API to it."""
    ins = _taa_inputs(*POST_SHAPE)
    h = ins[0].shape[0]
    kw = dict(catmull_history=catmull, full_rgb_catmull=full_rgb)
    full = ttaa.taa_resolve(*map(_t, ins), 0.05, 1000.0, **kw)
    want = np.asarray(jtaa.taa_resolve(*map(jnp.asarray, ins), 0.05, 1000.0, **kw))
    for y0, rows in ((0, 8), (8, 30), (h - 6, 6)):
        got = ttaa.taa_resolve(*map(_t, ins), 0.05, 1000.0, row_begin=y0, row_count=rows, **kw)
        _exact(got, full[y0:y0 + rows])
        _close(got, want[y0:y0 + rows])


# the chains of tests/test_torch_shade.py::test_bloom_matches_jax: 135x240
# and 54x96 meet odd sizes (135 -> 67, 27 -> 13), 64x64 goes down to 1x1
CHAINS = [((96, 160), 3), ((135, 240), 4), ((54, 96), 3), ((64, 64), 6)]


@functools.cache
def _jax_levels():
    """JAX's downsample_13tap and upsample_tent9, compiled once per shape
    (op by op, each small shape of a chain costs seconds of compiles)."""
    return (jax.jit(jbloom.downsample_13tap, static_argnums=(1, 2, 3)),
            jax.jit(jbloom.upsample_tent9, static_argnums=(1, 2, 3)))


def _hdr(shape, seed=3):
    return np.random.default_rng(seed).uniform(0, 3, shape + (3,)).astype(np.float32)


@pytest.mark.parametrize("shape,passes", CHAINS, ids=[f"{s[0]}x{s[1]}" for s, _ in CHAINS])
def test_bloom_levels_plain_match_jax(shape, passes):
    """Each level on the same input as JAX's: down levels, up levels, the
    final level with the base added, and the atlas."""
    sizes = tbloom.chain_sizes(*shape, passes)
    # POST_SHAPE's chain op by op: test_post_stack_matches_jax reuses its compiles
    jdown, jup = ((jbloom.downsample_13tap, jbloom.upsample_tent9) if shape == POST_SHAPE
                  else _jax_levels())
    cur = _hdr(shape)
    downs = []
    atlas, offs = tbloom.new_atlas(*shape, passes, "cpu")
    for i in range(1, passes + 1):
        got = tbloom.bloom_down_level(_t(cur), *sizes[i], i == 1, atlas=atlas,
                                      atlas_col=offs[i - 1])
        want = np.asarray(jdown(jnp.asarray(cur), *sizes[i], i == 1))
        _close(got, want)
        downs.append(got)
        cur = want
    jatlas = jsamp.pack_mip_atlas([jnp.asarray(d.numpy()) for d in downs]).astype(jnp.bfloat16)
    _exact(atlas, tsamp.pack_mip_atlas(downs).to(torch.bfloat16))
    _close(atlas.float(), np.asarray(jatlas.astype(jnp.float32)), 2 ** -7)
    for i in range(passes - 1, -1, -1):
        factor = 0.06 if i == 0 else 1.0
        base = _hdr(shape, 4) if i == 0 else None
        got = tbloom.bloom_up_level(_t(cur), *sizes[i], factor,
                                    base=None if base is None else _t(base))
        want = np.asarray(jup(jnp.asarray(cur), *sizes[i], factor))
        _close(got, want if base is None else base + want)
        cur = want


@pytest.mark.parametrize("shape", [(96, 160), (54, 96)])
def test_bloom_row_windows_plain(shape):
    """Level 1 and the final tent + tonemap over row windows: the whole
    level's rows bit for bit (the row-sharded frame's windows), and a
    source band written by a level with src_atlas_col."""
    hdr = _t(_hdr(shape))
    h, w = shape
    sizes = tbloom.chain_sizes(h, w, 2)
    d1 = tbloom.bloom_down_level(hdr, *sizes[1], True)
    for rb, rc in ((0, 8), (8, 16), (sizes[1][0] - 8, 8)):
        _exact(tbloom.bloom_down_level(hdr, *sizes[1], True, rows=(rb, rc)), d1[rb:rb + rc])
    base = _t(_hdr(shape, 5))
    final = tbloom.bloom_up_level(d1, h, w, 0.06, base=base, exposure=1.0)
    for rb, rc in ((0, 16), (16, 32), (h - 16, 16)):
        got = tbloom.bloom_up_level(d1, h, w, 0.06, base=base[rb:rb + rc], exposure=1.0,
                                    rows=(rb, rc))
        _exact(got, final[rb:rb + rc])
    atlas, offs = tbloom.new_atlas(h, w, 2, "cpu")
    d2 = tbloom.bloom_down_level(d1, *sizes[2], atlas=atlas, atlas_col=offs[1],
                                 src_atlas_col=offs[0])
    _exact(atlas, tsamp.pack_mip_atlas([d1, d2]).to(torch.bfloat16))


def test_tonemap_only_matches_jax():
    hdr = _hdr((24, 40))
    got = tbloom.bloom_up_level(None, 24, 40, base=_t(hdr), exposure=0.8)
    _close(got, jcolor.gamma_encode(jcolor.aces_approx(0.8 * jnp.asarray(hdr))))


def _post_cfgs(enable_taa, enable_bloom):
    jcfg = JaxConfig(width=POST_SHAPE[1], height=POST_SHAPE[0], bloom_pass_count=3,
                     enable_taa=enable_taa, enable_bloom=enable_bloom, exposure=1.2)
    return jcfg, RenderConfig(**{f: getattr(jcfg, f) for f in RenderConfig.__dataclass_fields__})


@pytest.mark.parametrize("enable_bloom", [True, False], ids=["bloom", "no_bloom"])
@pytest.mark.parametrize("enable_taa", [True, False], ids=["taa", "no_taa"])
def test_post_stack_matches_jax(enable_taa, enable_bloom):
    """Frame 0 (history = hdr) and frame 1 (the previous TAA output and
    velocity, the previous pyramid kept when bloom is off); the bloom levels
    meet odd sizes (27 -> 13).  JAX runs op by op, as the port does (jit
    fuses the history's f16 windows so that some texels round the other
    way), and frame 1 starts both from JAX's frame-0 state: the f16 history
    windows turn a last-bit difference into an f16 step."""
    jcfg, cfg = _post_cfgs(enable_taa, enable_bloom)
    h, w = POST_SHAPE
    jstate = jr.init_frame_state(jcfg)
    tstate = tr.init_frame_state(cfg, "cpu")
    rng = np.random.default_rng(7)
    prev_pyr = rng.uniform(0, 1, tstate.prev_pyramid.shape).astype(np.float32)
    jstate = jstate._replace(prev_pyramid=jnp.asarray(prev_pyr).astype(jnp.bfloat16))
    tstate.prev_pyramid = _t(prev_pyr).to(torch.bfloat16)
    for frame in range(2):
        hdr, depth, vel, _, _ = _taa_inputs(h, w, seed=10 + frame)
        want = jr.post_stack(jnp.asarray(hdr), jnp.asarray(depth), jnp.asarray(vel), jstate, jcfg)
        got = tr.post_stack(_t(hdr), _t(depth), _t(vel), tstate, cfg)
        for g, wnt in zip(got, want):
            _close(g.float(), np.asarray(wnt.astype(jnp.float32)),
                   2 ** -7 if g.dtype == torch.bfloat16 else 1e-5)
        jstate = jstate._replace(taa_history=want[1], velocity_prev=jnp.asarray(vel),
                                 prev_pyramid=want[2], frame_idx=jnp.int32(frame + 1))
        tstate.taa_history, tstate.velocity_prev = _t(want[1]), _t(vel)
        tstate.prev_pyramid = _t(np.asarray(want[2].astype(jnp.float32))).to(torch.bfloat16)
        tstate.frame_idx = frame + 1


def test_cpu_dispatch_takes_plain_versions():
    """On CPU tensors the wrappers return their plain versions' values and
    count no launch."""
    ins = [_t(a) for a in _taa_inputs()]
    hdr = _t(_hdr((24, 40)))
    counts = (ttaa.taa_resolve.launches, tbloom.bloom_down_level.launches,
              tbloom.bloom_up_level.launches)
    _exact(ttaa.taa_resolve(*ins), ttaa.taa_resolve_plain(*ins))
    _exact(tbloom.bloom_down_level(hdr, 12, 20, True),
           tbloom.bloom_down_level_plain(hdr, 12, 20, True))
    d1 = tbloom.downsample_13tap(hdr, 12, 20)
    _exact(tbloom.bloom_up_level(d1, 24, 40, 0.06, base=hdr, exposure=1.0),
           tbloom.bloom_up_level_plain(d1, 24, 40, 0.06, base=hdr, exposure=1.0))
    assert (ttaa.taa_resolve.launches, tbloom.bloom_down_level.launches,
            tbloom.bloom_up_level.launches) == counts


def test_wrappers_reject_bad_inputs():
    ins = [_t(a) for a in _taa_inputs()]
    hdr = _t(_hdr((24, 40)))
    with pytest.raises(ValueError, match="float32"):
        ttaa.taa_resolve(ins[0].double(), *ins[1:])
    with pytest.raises(ValueError, match="shape"):
        ttaa.taa_resolve(*ins[:4], ins[4][:12])
    with pytest.raises(ValueError, match="rows"):
        ttaa.taa_resolve(*ins, row_begin=20, row_count=8)
    with pytest.raises(ValueError, match="float32"):
        tbloom.bloom_down_level(hdr.double(), 12, 20)
    with pytest.raises(ValueError, match="atlas"):
        tbloom.bloom_down_level(hdr, 12, 20, atlas=torch.zeros((12, 20, 3)))
    with pytest.raises(ValueError, match="cannot go up"):
        tbloom.bloom_up_level(hdr, 12, 20)
    with pytest.raises(ValueError, match="shape"):
        tbloom.bloom_up_level(None, 24, 40, base=hdr[:8], exposure=1.0)
