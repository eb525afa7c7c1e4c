"""Seed-made inputs of shade/gi.py voxelize_scene (csrc/voxelize.cu): the
scene tables voxelize reads, a sun map and the stream's configuration,
built with numpy alone, shared by the CPU tests
(test_torch_voxelize_kernel.py), the card tests (test_torch_cuda.py) and
chip_smoke.py.  Imports no jax and no torch.

Every set has the same shapes (TRIS triangles, a LAYERS x TEX atlas, a
SUN^2 map, a GRID^3 grid, a stream of TOTAL samples), so a reference
compiled op by op for one set serves them all.  The grid spans [-8, 8]^3
(scale 1/8: a voxel is one unit, a triangle of area a takes ceil(4a)
samples).  Texture uvs run over [-3, 3] (the wrap addressing's negative
coordinates).  Each set is a dict: tri_attr f32 [T,24], mat_id i32 [T],
sun (angle x, angle y, half size), texture_lod, and what it exercises:
  * planes: 12 large triangles of up to ~320 samples beside one-sample ones;
  * one_sample: every triangle one sample;
  * zero_area: half the triangles collinear or with coincident corners;
  * outside: triangles across and beyond the grid's faces;
  * emissive: most triangles on the emissive layer;
  * sun_edge: a sun map of half size 5 under a scene out to 8, so samples
    fall past the map's edges (the clamped window, fx zeroed);
  * cut: more samples than the stream holds, and one triangle with more
    than the whole stream (its count clipped);
  * lod: texture lod 2.6 (level 3) and uvs out to 20.
"""

import numpy as np

TRIS, LAYERS, TEX, SUN, GRID, SCALE, TOTAL = 384, 3, 64, 64, 16, 1.0 / 8.0, 4096
EMISSION = (np.float32(5.0) * np.asarray((1.0, 0.9, 0.7), np.float32)).astype(np.float32)


def atlas():
    """(tex_packed u8 [LAYERS, TEX, Wa, 48], tex_scale f32 [12]): random
    window rows; layer 2's emissive channels (9-11 of each corner) high."""
    rng = np.random.default_rng(200)
    wa = sum(max(1, TEX >> k) for k in range(int(np.log2(TEX)) + 1))
    packed = rng.integers(0, 256, (LAYERS, TEX, wa, 48), dtype=np.uint8)
    packed[:2, ..., [c + 12 * k for k in range(4) for c in (9, 10, 11)]] //= 16
    scale = rng.uniform(1.0, 2.0, 12).astype(np.float32)
    scale[9:] = 4.0
    return packed, scale


def sun_depth():
    """f32 [SUN, SUN] depths in [0.2, 1], exact 0 and 1 on a few texels."""
    rng = np.random.default_rng(201)
    d = rng.uniform(0.2, 1.0, (SUN, SUN)).astype(np.float32)
    d[0, :8] = 0.0
    d[-1, -8:] = 1.0
    return d


def _tri_attr(pos, uv, rng):
    """[T,24]: positions (9), normals (9, unread by voxelize), uvs (6)."""
    t = pos.shape[0]
    nrm = rng.normal(size=(t, 9)).astype(np.float32)
    return np.concatenate([pos.reshape(t, 9), nrm, uv.reshape(t, 6)], 1).astype(np.float32)


def _small(rng, n, lo, hi, size):
    c = rng.uniform(lo, hi, (n, 1, 3))
    return c + rng.uniform(-size, size, (n, 3, 3))


def _quad_tris(rng, n, half):
    """n triangles of planes in random orientation, legs up to 2 * half."""
    o = rng.uniform(-6, 6, (n, 1, 3))
    a = rng.normal(size=(n, 1, 3))
    b = rng.normal(size=(n, 1, 3))
    a *= half / np.linalg.norm(a, axis=-1, keepdims=True)
    b *= half / np.linalg.norm(b, axis=-1, keepdims=True)
    return np.concatenate([o - a, o + a, o + b], 1)


def _set(name, seed):
    rng = np.random.default_rng(seed)
    t = TRIS
    uv = rng.uniform(-3, 3, (t, 3, 2))
    mat = rng.integers(0, LAYERS, t)
    sun, lod = (40.0 + seed, 20.0 + 7 * seed, 8.0), 4.0
    if name == "planes":
        pos = np.concatenate([_quad_tris(rng, 12, 9.0), _small(rng, t - 12, -7, 7, 0.15)])
    elif name == "one_sample":
        pos = _small(rng, t, -7.5, 7.5, 0.2)
    elif name == "zero_area":
        pos = _small(rng, t, -7, 7, 0.8)
        h = t // 2
        pos[:h // 2, 2] = pos[:h // 2, 0] + 2.0 * (pos[:h // 2, 1] - pos[:h // 2, 0])
        pos[h // 2:h, 1] = pos[h // 2:h, 0]
        pos[h // 2:h:2, 2] = pos[h // 2:h:2, 0]
    elif name == "outside":
        pos = _small(rng, t, -14, 14, 1.5)
    elif name == "emissive":
        pos = _small(rng, t, -7, 7, 0.8)
        mat = np.where(rng.random(t) < 0.8, 2, mat)
    elif name == "sun_edge":
        pos = _small(rng, t, -8, 8, 0.6)
        sun = (50.0, 35.0, 5.0)
    elif name == "cut":
        pos = np.concatenate([_quad_tris(rng, 1, 80.0), _small(rng, t - 1, -7, 7, 3.0)])
    elif name == "lod":
        pos = _small(rng, t, -7, 7, 0.8)
        uv = rng.uniform(-20, 20, (t, 3, 2))
        lod = 2.6
    else:
        raise KeyError(name)
    return dict(tri_attr=_tri_attr(pos.astype(np.float32), uv.astype(np.float32), rng),
                mat_id=mat.astype(np.int32), sun=sun, texture_lod=lod)


NAMES = ("planes", "one_sample", "zero_area", "outside", "emissive", "sun_edge", "cut", "lod")
SETS = {name: (lambda name=name, seed=i: _set(name, seed)) for i, name in enumerate(NAMES)}


def counts(tri_attr, total=TOTAL):
    """Each triangle's sample count, as voxelize_sample_capacity counts
    them in numpy (float32 areas): clipped to [1, total]."""
    p = tri_attr[:, :9].reshape(-1, 3, 3)
    area = 0.5 * np.linalg.norm(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1)
    voxel = 2.0 / (GRID * SCALE)
    return np.clip(np.ceil(area / (voxel * voxel) * 4.0).astype(np.int64), 1, total)
