"""raster/setup.py transform_and_setup, the entry point of csrc/setup.cu,
against the JAX package's transform_to_clip + setup_triangles on the CPU.

On a CPU tensor transform_and_setup is the port's own composition
setup_triangles(transform_to_clip(...)), the kernel's plain version: these
tests hold it to JAX on the seeded sets of test_torch_setup_inputs.py (a
perspective camera's triangles in front of, behind and across the near
plane; a vertex at |w| < 1e-6, at w = 0 and at w = 1e-6; det == 0; one
triangle; none) in every cull mode, with and without the TAA jitter, and on
the renderer's strided view of scene.tri_attr.  The kernel itself is held
bit for bit to the composition on the card (test_torch_cuda.py,
chip_smoke.py).

Tolerances are test_torch_raster.py's: bbox, valid and z_mode exactly;
adj, c_w, z_vert and det rtol = atol = 1e-6; the cancelling depth plane
c_z within the rounding bound of its dot product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_setup_inputs import JITTER, SETS, tri_attr_view
from vulkan_pbr_renderer_tpu.raster import setup as jsetup
from vulkan_pbr_renderer_tpu_torch.raster import setup as tsetup

CULLS = ("back", "front", "none")


def _jax(pos, mat, w, h, cull, jitter):
    clip = jsetup.transform_to_clip(jnp.asarray(pos), jnp.asarray(mat),
                                    None if jitter is None else jnp.asarray(jitter))
    return jsetup.setup_triangles(clip, w, h, cull=cull), np.asarray(clip)


def _check(ts, js, clip, what):
    for name in ("bbox", "valid", "z_mode"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=f"{what}: {name}")
    for name in ("adj", "c_w", "z_vert", "det"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=f"{what}: {name}")
    adj, det = np.asarray(js.adj), np.asarray(js.det)
    bound = (np.abs(adj) @ np.abs(clip[..., 2])[..., None])[..., 0]
    bound = 4 * np.finfo(np.float32).eps * bound / np.maximum(np.abs(det), 1.0)[:, None]
    assert (np.abs(ts.c_z.numpy() - np.asarray(js.c_z)) <= bound + 1e-12).all(), \
        f"{what}: c_z"
    for name in tsetup.TriSetup._fields:
        got, want = getattr(ts, name), np.asarray(getattr(js, name))
        assert tuple(got.shape) == want.shape and got.is_contiguous(), f"{what}: {name}"


@pytest.mark.parametrize("strided", [False, True], ids=["dense", "tri_attr_view"])
@pytest.mark.parametrize("jitter", [False, True], ids=["no_jitter", "jitter"])
@pytest.mark.parametrize("cull", CULLS)
def test_transform_and_setup_matches_jax(cull, jitter, strided):
    """Every seeded set in this cull mode, jitter and input layout."""
    jit = JITTER if jitter else None
    before = tsetup.transform_and_setup.launches
    for name, make in SETS.items():
        pos, mat, w, h = make()
        if strided:
            table = torch.from_numpy(tri_attr_view(pos))
            tri_pos = table[:, :9].reshape(-1, 3, 3)
            assert pos.shape[0] < 2 or tri_pos.stride() == (24, 3, 1)
        else:
            tri_pos = torch.from_numpy(pos)
        ts = tsetup.transform_and_setup(tri_pos, torch.from_numpy(mat), w, h, cull=cull,
                                        jitter=None if jit is None else torch.from_numpy(jit))
        js, clip = _jax(pos, mat, w, h, cull, jit)
        _check(ts, js, clip, f"{name} cull={cull} jitter={jitter}")
    # the CPU path is the plain composition: no kernel launch counted
    assert tsetup.transform_and_setup.launches == before


def test_edge_set_regimes():
    """The edge set holds what it is for: vertices behind and across
    w = 1e-6 (some triangles extend their bbox to the border), a vertex at
    |w| < 1e-6 and at w = 0, det == 0 (invalid in every mode, adj all zero
    under cull="none"), triangles culled by facing in "back" and "front"."""
    pos, mat, w, h = SETS["edges"]()
    clip = jsetup.transform_to_clip(jnp.asarray(pos), jnp.asarray(mat))
    wv = np.asarray(clip)[..., 3]
    assert ((np.abs(wv) < 1e-6) & (wv != 0)).any() and (wv == 0).any()
    assert (wv == np.float32(1e-6)).any()
    front = wv > np.float32(1e-6)
    assert ((front.sum(1) == 1) | (front.sum(1) == 2)).sum() >= 8 and (front.sum(1) == 0).any()
    out = {c: tsetup.transform_and_setup(torch.from_numpy(pos), torch.from_numpy(mat), w, h,
                                         cull=c) for c in CULLS}
    zero = out["none"].det == 0
    assert int(zero.sum()) >= 6
    assert not bool(out["none"].valid[zero].any())
    assert bool((out["none"].adj[zero] == 0).all())
    assert bool(out["back"].valid.any()) and bool(out["front"].valid.any())
    full = out["none"].bbox[out["none"].valid]
    assert bool(((full[:, 0] == 0) & (full[:, 2] == w)).any())   # extended to the border


def test_transform_and_setup_cpu_checks():
    """A CPU tensor takes the plain composition: a bad cull mode raises as
    setup_triangles does, and the fields are the composition's exactly."""
    pos, mat, w, h = SETS["perspective400_seed7"]()
    with pytest.raises(ValueError):
        tsetup.transform_and_setup(torch.from_numpy(pos), torch.from_numpy(mat), w, h,
                                   cull="sideways")
    got = tsetup.transform_and_setup(torch.from_numpy(pos), torch.from_numpy(mat), w, h,
                                     cull="back", jitter=torch.from_numpy(JITTER))
    want = tsetup.setup_triangles(tsetup.transform_to_clip(
        torch.from_numpy(pos), torch.from_numpy(mat), torch.from_numpy(JITTER)), w, h, "back")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
