"""The G-buffer kernel's plain version (shade/gbuffer.py gbuffer_pass_plain,
the reference of csrc/gbuffer.cu) against the JAX package's gbuffer_pass,
on tests/test_torch_shade_inputs.py's frame at 64x48: alpha-tested
triangles, mirrored-uv triangles, uncovered pixels, a row band; and the
per-scene attribute table (gbuffer_static) of a JAX-converted scene against
the JAX package's own packed row and the port's own scene.

Each package gets the same inputs (the port's raster handed to JAX as
numpy).  Tolerances: coverage exactly equal; normal, orm, emissive, depth
and velocity atol / rtol 1e-5; base_color 1e-4 (XLA fuses the barycentric
dot products into FMAs on the CPU, the port rounds each product: uv moves
by an ulp and the bilinear weights follow the checker's hard edges).  The
kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_shade_inputs import gbuffer_inputs, shade_scene
from vulkan_pbr_renderer_tpu.assets import MaterialDesc, build_scene, procedural
from vulkan_pbr_renderer_tpu.raster import setup as jsetup
from vulkan_pbr_renderer_tpu.shade import gbuffer as jgb
from vulkan_pbr_renderer_tpu_torch import convert
from vulkan_pbr_renderer_tpu_torch.shade import gbuffer as tgb

H, W = 48, 64


@functools.cache
def _scenes():
    """(JAX scene, port scene): test_torch_shade_inputs.shade_scene built by
    each package (every third triangle's u mirrored in both)."""
    tscene = shade_scene("cpu")
    checker = np.asarray(procedural.checker_texture(32, 4), np.float32)[..., :3]
    alpha = np.where(checker[..., :1] < 0.5, 0.1, 1.0).astype(np.float32)
    mats = [MaterialDesc(base_color=np.concatenate([checker, alpha], -1),
                         normal=procedural.bump_normal_texture(32),
                         orm_factor=(1.0, 0.6, 0.3), alpha_test=True),
            MaterialDesc(base_color_factor=(0.7, 0.2, 0.15, 1.0), orm_factor=(1.0, 0.35, 0.0),
                         emissive_factor=(0.5, 0.2, 0.0))]
    parts = [procedural.make_plane((0, 0, 0), (14, 14), 2, 0, uv_scale=4),
             procedural.make_cube((0, 0, 1.0), (1.5, 1.5, 2.0), 1)]
    jscene = build_scene(parts, mats, texture_size=32)
    attr = np.array(jscene.tri_attr)
    flip = np.arange(attr.shape[0]) % 3 == 0
    attr[flip, 18:24:2] = 1.0 - attr[flip, 18:24:2]
    jscene = jscene._replace(tri_attr=jnp.asarray(attr))
    np.testing.assert_array_equal(attr, tscene.tri_attr.numpy())
    np.testing.assert_array_equal(np.asarray(jscene.tex_packed), tscene.tex_packed.numpy())
    return jscene, tscene


def _close(got, want, tol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("band", [None, (13, 21)], ids=["frame", "band_13_21"])
@pytest.mark.parametrize("material_filter", ["stochastic", "trilinear", "nearest"])
def test_gbuffer_plain_matches_jax(material_filter, band):
    jscene, tscene = _scenes()
    kw, _, _ = gbuffer_inputs(tscene, H, W, band=band)
    s = jsetup.TriSetup(*(jnp.asarray(x.numpy()) for x in kw["setup"]))
    depth1 = torch.where(torch.isinf(kw["depth"]), 1.0, kw["depth"])
    want = jgb.gbuffer_pass(
        jscene, s, jnp.asarray(depth1.numpy()), jnp.asarray(kw["tri_id"].numpy()),
        jnp.asarray(kw["clip_from_world"].numpy()), jnp.asarray(kw["old_clip_from_world"].numpy()),
        0.3, world_from_clip=jnp.asarray(kw["world_from_clip"].numpy()),
        jitter=jnp.asarray(kw["jitter"].numpy()), material_filter=material_filter,
        frame_idx_mod_59=jnp.float32(kw["frame_idx_mod_59"]), row_offset=kw["row_offset"],
        full_size=kw["full_size"])
    got = tgb.gbuffer_pass_plain(
        tscene, tgb.gbuffer_static(tscene), kw["setup"], kw["depth"], kw["tri_id"],
        kw["clip_from_world"], kw["old_clip_from_world"], 0.3, kw["world_from_clip"],
        kw["jitter"], material_filter, kw["frame_idx_mod_59"], kw["row_offset"],
        kw["full_size"])
    cov = np.asarray(want.coverage)
    assert cov.any() and not cov.all()
    assert bool(((kw["tri_id"] >= 0) & ~got.coverage).any())      # alpha-tested pixels cut
    np.testing.assert_array_equal(got.coverage.numpy(), cov)
    for name in ("normal", "orm", "emissive", "depth", "velocity"):
        _close(getattr(got, name), getattr(want, name), what=name)
    _close(got.base_color, want.base_color, 1e-4, "base_color")


def test_gbuffer_static_of_converted_scene():
    """gbuffer_static of the JAX scene carried over by convert.py equals the
    port's own scene's table and the JAX package's packed static row: uv f32
    bit for bit, the normals as its f16, the material id and alpha flag."""
    jscene, tscene = _scenes()
    carried = convert.scene_from_numpy({k: np.asarray(v) for k, v in jscene._asdict().items()},
                                       device="cpu")
    got = tgb.gbuffer_static(carried).numpy()
    np.testing.assert_array_equal(got, tgb.gbuffer_static(tscene).numpy())
    row = np.asarray(jgb.pack_gbuffer_static(jscene))                   # u16 [T,24]
    uv = jax.lax.bitcast_convert_type(jnp.asarray(row[:, :12]).reshape(-1, 6, 2),
                                      jnp.float32)
    f16 = np.asarray(row[:, 12:24]).view(np.float16).astype(np.float32)
    np.testing.assert_array_equal(got[:, 0:6], np.asarray(uv))
    np.testing.assert_array_equal(got[:, 6:15], f16[:, 0:9])
    np.testing.assert_array_equal(got[:, 15], f16[:, 9] * 2.0 + (f16[:, 10] > 0.5))
    assert (got[:, 15] % 2 == 1).any() and (got[:, 15] % 2 == 0).any()


def test_gbuffer_pass_cpu_takes_plain_version():
    """On CPU tensors gbuffer_pass is gbuffer_pass_plain, bit for bit, and
    counts no launch; a bad input raises before anything runs."""
    _, tscene = _scenes()
    kw, _, _ = gbuffer_inputs(tscene, H, W, band=(5, 30))
    static = tgb.gbuffer_static(tscene)
    args = (kw["setup"], kw["depth"], kw["tri_id"], kw["clip_from_world"],
            kw["old_clip_from_world"], 0.3)
    before = tgb.gbuffer_pass.launches
    got = tgb.gbuffer_pass(tscene, *args, world_from_clip=kw["world_from_clip"],
                           jitter=kw["jitter"], material_filter="stochastic",
                           frame_idx_mod_59=kw["frame_idx_mod_59"], row_offset=kw["row_offset"],
                           full_size=kw["full_size"])
    want = tgb.gbuffer_pass_plain(tscene, static, *args, kw["world_from_clip"], kw["jitter"],
                                  "stochastic", kw["frame_idx_mod_59"], kw["row_offset"],
                                  kw["full_size"])
    assert tgb.gbuffer_pass.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="int32"):
        tgb.gbuffer_pass(tscene, kw["setup"], kw["depth"], kw["tri_id"].long(),
                         *args[3:])
    with pytest.raises(ValueError, match="material_filter"):
        tgb.gbuffer_pass(tscene, *args, material_filter="box")
