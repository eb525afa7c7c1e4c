"""Seed-made inputs of raster/setup.py transform_and_setup (csrc/setup.cu):
world triangles [N,3,3], a [4,4] matrix and the viewport, built with numpy
alone, shared by the CPU tests (test_torch_setup_kernel.py), the card tests
(test_torch_cuda.py) and chip_smoke.py.  Imports no jax and no torch.

Each set is (positions f32 [N,3,3], mat f32 [4,4], width, height):
  * perspective: random triangles around a perspective camera (near plane
    0.05): in front, behind, and crossing w = 1e-6 with one or two
    vertices behind it;
  * edges: hand-placed triangles under a matrix whose w is the world z, on
    values whose products are exact: a vertex at |w| < 1e-6, at w = 0, at
    w = 1e-6 exactly and just below 0; one and two vertices behind; all
    behind; two and three coincident vertices and three collinear ones
    (det == 0 exactly); off screen; each in both windings;
  * one: a single triangle; empty: no triangle.
"""

import numpy as np

EPS = np.float32(1e-6)


def _perspective(fov_y_deg, aspect, near, far):
    """utils/math3d.py perspective_lh_zo, in numpy."""
    f = 1.0 / np.tan(np.deg2rad(fov_y_deg) / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (far - near)
    m[2, 3] = -far * near / (far - near)
    m[3, 2] = 1.0
    return m


def _look_at(eye, target, up=(0.0, 0.0, 1.0)):
    """utils/math3d.py look_at, in numpy (+X right, +Y down, +Z forward)."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    f = target - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    d = np.cross(f, r)
    m = np.eye(4)
    m[:3, :3] = np.stack([r, d, f])
    m[:3, 3] = -(m[:3, :3] @ eye)
    return m.astype(np.float32)


def perspective_set(n, seed, width=96, height=64):
    """n triangles of up to ~1.5 units around a camera at the origin looking
    along +y: some in front, some behind, many crossing the near plane."""
    rng = np.random.default_rng(seed)
    center = rng.uniform((-3.0, -1.5, -2.0), (3.0, 6.0, 2.0), (n, 1, 3))
    pos = (center + rng.uniform(-0.75, 0.75, (n, 3, 3))).astype(np.float32)
    mat = (_perspective(60.0, width / height, 0.05, 100.0).astype(np.float64)
           @ _look_at((0.0, 0.0, 0.0), (0.0, 1.0, 0.0))).astype(np.float32)
    return pos, mat, width, height


def _w_matrix():
    """clip = (x, y, 0.5 z, z): the world z is the clip w."""
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = m[1, 1] = 1.0
    m[2, 2] = 0.5
    m[3, 2] = 1.0
    return m


def edge_set(width=64, height=48):
    """Hand-placed triangles, rows (x, y, w), each in both windings."""
    tiny, below = np.float32(4e-7), np.float32(-1e-7)
    tris = [
        [(-0.5, -0.5, 1.0), (0.5, -0.5, 1.0), (-0.5, 0.5, 1.0)],        # in front
        [(-0.25, -0.5, 2.0), (0.75, 0.25, 1.5), (-0.5, 0.5, 0.5)],      # in front, varied w
        [(-0.5, -0.5, 1.0), (0.5, -0.5, 1.0), (0.0, 0.5, -0.5)],        # one behind
        [(-0.5, -0.5, 1.0), (0.5, -0.5, -1.0), (0.0, 0.5, -0.5)],       # two behind
        [(-0.5, -0.5, -1.0), (0.5, -0.5, -1.0), (0.0, 0.5, -2.0)],      # all behind
        [(0.25, 0.25, 1.0), (-0.25, 0.25, 1.0), (0.125, -0.25, tiny)],  # |w| < 1e-6
        [(0.25, 0.25, 1.0), (-0.25, 0.25, 1.0), (0.25, -0.5, 0.0)],     # w = 0
        [(0.25, 0.25, 1.0), (-0.25, 0.25, 1.0), (0.25, -0.5, EPS)],     # w = 1e-6
        [(0.25, 0.25, 1.0), (-0.25, 0.25, 1.0), (0.25, -0.5, below)],   # w just below 0
        [(0.5, 0.25, 0.0), (-0.25, 0.25, 0.0), (0.25, -0.5, 1.0)],      # two at w = 0
        [(0.25, 0.25, 1.0), (0.25, 0.25, 1.0), (-0.5, 0.5, 1.0)],       # two coincide
        [(0.25, 0.25, 1.0), (0.25, 0.25, 1.0), (0.25, 0.25, 1.0)],      # three coincide
        [(0.0, 0.0, 1.0), (0.25, 0.25, 1.0), (0.5, 0.5, 1.0)],          # collinear
        [(0.0, 0.0, 1.0), (0.25, 0.25, 1.0), (0.5, 0.5, -1.0)],         # det 0, crossing
        [(4.0, 4.0, 1.0), (5.0, 4.0, 1.0), (4.0, 5.0, 1.0)],            # off screen
        [(-0.5, -0.5, 1.0), (0.5, -0.5, 1.0), (0.0, 0.5, -1.0)],        # crossing at x = 0
        [(-3.0, -3.0, 1.0), (5.0, -3.0, 1.0), (-3.0, 5.0, 1.0)],        # covers the screen
        [(0.75, -0.25, 1e-5), (-0.5, 0.25, 1.0), (0.0, 0.5, 2.0)],      # near w = eps
    ]
    tris = np.asarray(tris, np.float32)
    both = np.concatenate([tris, tris[:, ::-1]])       # the other winding
    return np.ascontiguousarray(both), _w_matrix(), width, height


def one_set():
    pos, mat, w, h = perspective_set(64, 3)
    return np.ascontiguousarray(pos[17:18]), mat, w, h


def empty_set():
    pos, mat, w, h = perspective_set(4, 5)
    return np.zeros((0, 3, 3), np.float32), mat, w, h


SETS = {
    "perspective400_seed7": lambda: perspective_set(400, 7),
    "perspective300_seed9_odd": lambda: perspective_set(300, 9, width=97, height=61),
    "edges": edge_set,
    "one": one_set,
    "empty": empty_set,
}

# the TAA jitter of a frame (NDC), as the renderer passes it
JITTER = np.array([0.00131, -0.00217], np.float32)


def tri_attr_view(pos, cols=24, seed=0):
    """pos inside an [N, cols] table at columns 0-8 (scene.tri_attr's
    layout: 96-byte rows), the rest random: returns the table; the
    renderer's view is table[:, :9].reshape(-1, 3, 3)."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (pos.shape[0], cols)).astype(np.float32)
    table[:, :9] = pos.reshape(-1, 9)
    return table
