"""The port's bake_irradiance against the JAX package's.

Both sum each chunk's samples and add the chunk sums in order, in f32; the
cubemap sampler's f32 operations differ in order by a few ulp, so the
tolerance is atol 1e-5 on values of order 1.  The properties of
tests/test_bake.py (constant env, sky gradient) hold on the port too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.assets import procedural as jproc
from vulkan_pbr_renderer_tpu.bake import ibl as jibl
from vulkan_pbr_renderer_tpu.gpu import sampling as jsampling
from vulkan_pbr_renderer_tpu_torch.assets import procedural as tproc
from vulkan_pbr_renderer_tpu_torch.bake import ibl as tibl
from vulkan_pbr_renderer_tpu_torch.gpu import sampling as tsampling


@pytest.fixture(scope="module")
def sky_atlas():
    """The procedural sky's cube mip atlas, built by the JAX package and
    handed over as numpy."""
    env = jproc.make_sky_cubemap(32, sun_intensity=0.0)
    return np.array(jsampling.build_cube_mip_atlas(jnp.asarray(env))), 32


@pytest.mark.parametrize("size,samples,chunk", [(8, 64, 16), (4, 40, 64), (8, 96, 32)])
def test_bake_irradiance_matches_jax(sky_atlas, size, samples, chunk):
    atlas, base = sky_atlas
    want = np.asarray(jibl.bake_irradiance(jnp.asarray(atlas), base, size=size,
                                           samples=samples, chunk=chunk))
    got = tibl.bake_irradiance(atlas, base, size=size, samples=samples, chunk=chunk,
                               device="cpu")
    assert got.shape == (6, size, size, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_bake_irradiance_takes_the_ports_atlas(sky_atlas):
    """The port's own atlas builder feeds it too (a tensor, not numpy)."""
    atlas, base = sky_atlas
    env = torch.from_numpy(tproc.make_sky_cubemap(32, sun_intensity=0.0))
    own = tsampling.build_cube_mip_atlas(env)
    np.testing.assert_allclose(own.numpy(), atlas, rtol=0, atol=1e-6)
    a = tibl.bake_irradiance(own, base, size=4, samples=32, chunk=16, device="cpu")
    b = tibl.bake_irradiance(atlas, base, size=4, samples=32, chunk=16, device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_irradiance_constant_env():
    """A constant env must bake to irradiance = mean(cos(pitch)) * color; the
    equal-area hemisphere set gives E[cos(pitch)] = 0.5."""
    const = torch.ones((6, 16, 16, 3)) * torch.tensor([2.0, 1.0, 0.5])
    atlas = tsampling.build_cube_mip_atlas(const)
    irr = tibl.bake_irradiance(atlas, 16, size=8, samples=256, device="cpu").numpy()
    np.testing.assert_allclose(irr[..., 0], 2.0 * 0.5, rtol=0.05)
    np.testing.assert_allclose(irr[..., 2] / irr[..., 0], 0.25, rtol=0.01)


def test_irradiance_follows_sky_gradient(sky_atlas):
    atlas, base = sky_atlas
    irr = tibl.bake_irradiance(atlas, base, size=8, samples=256, device="cpu").numpy()
    # faces: 0 +X, 1 -X, 2 +Y, 3 -Y, 4 +Z, 5 -Z; world up is +Z => face 4 sees sky
    assert irr[4].mean() > irr[5].mean()


def test_bake_irradiance_raises_without_cuda(sky_atlas):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    atlas, base = sky_atlas
    with pytest.raises(RuntimeError, match="cuda"):
        tibl.bake_irradiance(atlas, base, size=4, samples=16)
