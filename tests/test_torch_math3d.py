"""The quaternion and matrix helpers the FPS camera needs (mix, saturate,
quat_identity/mul/conj/normalize/slerp, mat4_identity, translate, scale)
against the JAX package, atol 1e-6 (the same f32 operations in the same
order), and the quaternion cases of tests/test_math3d.py on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_pbr_renderer_tpu.utils import math3d as jm3
from vulkan_pbr_renderer_tpu_torch.utils import math3d as tm3


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_mix_saturate_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(30, 3)).astype(np.float32)
    b = rng.normal(size=(30, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (30, 1)).astype(np.float32)
    _close(tm3.mix(*map(torch.from_numpy, (a, b, t))), jm3.mix(*map(jnp.asarray, (a, b, t))))
    _close(tm3.saturate(torch.from_numpy(a)), jm3.saturate(jnp.asarray(a)))


def test_constants_match_jax():
    _close(tm3.quat_identity(), jm3.quat_identity())
    _close(tm3.mat4_identity(), jm3.mat4_identity())
    v = (1.5, -2.0, 0.25)
    _close(tm3.translate(v), jm3.translate(v))
    _close(tm3.scale(v), jm3.scale(v))
    _close(tm3.translate(torch.tensor(v)), jm3.translate(jnp.asarray(v)))


def test_quat_mul_conj_normalize_match_jax():
    a, b = _quats(40, 1), _quats(40, 2)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    _close(tm3.quat_mul(ta, tb), jm3.quat_mul(ja, jb))
    _close(tm3.quat_conj(ta), jm3.quat_conj(ja))
    _close(tm3.quat_normalize(3.0 * ta), jm3.quat_normalize(3.0 * ja))
    # q * conj(q) = identity for unit quats
    _close(tm3.quat_mul(ta, tm3.quat_conj(ta)), np.tile(np.float32([0, 0, 0, 1]), (40, 1)))
    _close(tm3.quat_normalize(torch.zeros(4)), np.zeros(4, np.float32))


@pytest.mark.parametrize("t", [0.0, 0.2, 0.5, 1.0])
def test_quat_slerp_matches_jax(t):
    a, b = _quats(12, 3), _quats(12, 4)
    b[3] = a[3]            # parallel: the lerp branch
    b[4] = -a[4]           # antipodal: the sign flip
    for qa, qb in zip(a, b):
        got = tm3.quat_slerp(torch.from_numpy(qa), torch.from_numpy(qb), t)
        _close(got, jm3.quat_slerp(jnp.asarray(qa), jnp.asarray(qb), t))
        assert abs(float(torch.linalg.vector_norm(got)) - 1.0) < 1e-6


def test_quat_roundtrip():
    q = tm3.quat_from_axis_angle(torch.tensor([0.0, 0.0, 1.0]), torch.tensor(np.pi / 2))
    m = tm3.quat_to_mat4(q)
    v = tm3.transform_dirs(m, torch.tensor([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(v.numpy(), [0.0, 1.0, 0.0], atol=1e-6)


def test_quat_mul_compose():
    z = torch.tensor([0.0, 0.0, 1.0])
    qa = tm3.quat_from_axis_angle(z, torch.tensor(0.3))
    qb = tm3.quat_from_axis_angle(z, torch.tensor(0.5))
    expect = tm3.quat_from_axis_angle(z, torch.tensor(0.8))
    np.testing.assert_allclose(tm3.quat_mul(qa, qb).numpy(), expect.numpy(), atol=1e-6)


def test_inverse_of_translate_rotate():
    m = tm3.translate([1.0, 2.0, 3.0]) @ tm3.rotate_rh(torch.tensor(0.7),
                                                       torch.tensor([0.0, 0.0, 1.0]))
    np.testing.assert_allclose((m @ tm3.inverse(m)).numpy(), np.eye(4), atol=1e-5)
    want = jm3.translate([1.0, 2.0, 3.0]) @ jm3.rotate_rh(0.7, [0.0, 0.0, 1.0])
    _close(m, want)
