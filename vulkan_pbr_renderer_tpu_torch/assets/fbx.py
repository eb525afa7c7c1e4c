"""FBX 7.x binary loader (pure python + numpy).

Replaces the assimp FBX path the reference uses for SunTemple + the skybox
(asset_import.cpp:89: aiImportFile with Triangulate | PreTransformVertices |
GlobalScale | CalcTangentSpace).  Covers the binary node-record format with
zlib-compressed arrays, Geometry (polygons triangulated by fan), per-geometry
normals/UVs in the common mapping modes, Model transforms (Lcl TRS +
geometric TRS), OO connections, and materials by layer assignment.

Conventions match the reference import: GlobalScale uses the scene's
UnitScaleFactor (cm -> our units /100), axis conversion mirrors
asset_import.cpp:121-126 (swap Y/Z to make Z up, flip UV V).

Numpy copy of vulkan_pbr_renderer_tpu/assets/fbx.py, which cannot be imported
without importing jax.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .scene import MaterialDesc, MeshPart

_MAGIC = b"Kaydara FBX Binary  \x00"


def _read_props(data, pos, count):
    props = []
    for _ in range(count):
        t = data[pos : pos + 1]
        pos += 1
        if t == b"Y":
            (v,) = struct.unpack_from("<h", data, pos); pos += 2
        elif t == b"C":
            v = bool(data[pos]); pos += 1
        elif t == b"I":
            (v,) = struct.unpack_from("<i", data, pos); pos += 4
        elif t == b"L":
            (v,) = struct.unpack_from("<q", data, pos); pos += 8
        elif t == b"F":
            (v,) = struct.unpack_from("<f", data, pos); pos += 4
        elif t == b"D":
            (v,) = struct.unpack_from("<d", data, pos); pos += 8
        elif t in (b"f", b"d", b"i", b"l", b"b"):
            n, enc, clen = struct.unpack_from("<III", data, pos)
            pos += 12
            dt = {b"f": np.float32, b"d": np.float64, b"i": np.int32,
                  b"l": np.int64, b"b": np.uint8}[t]
            if enc:
                raw = zlib.decompress(data[pos : pos + clen])
                pos += clen
            else:
                nbytes = n * np.dtype(dt).itemsize
                raw = data[pos : pos + nbytes]
                pos += nbytes
            v = np.frombuffer(raw, dt)
        elif t in (b"S", b"R"):
            (n,) = struct.unpack_from("<I", data, pos)
            pos += 4
            v = data[pos : pos + n]
            pos += n
            if t == b"S":
                v = v.split(b"\x00\x01")[0].decode("utf-8", "replace")
        else:
            raise ValueError(f"unknown FBX property type {t!r}")
        props.append(v)
    return props, pos


def _read_node(data, pos, version):
    if version >= 7500:
        end, nprops, _plen = struct.unpack_from("<QQQ", data, pos)
        pos += 24
        nlen = data[pos]
        pos += 1
    else:
        end, nprops, _plen = struct.unpack_from("<III", data, pos)
        pos += 12
        nlen = data[pos]
        pos += 1
    if end == 0:
        return None, pos
    name = data[pos : pos + nlen].decode("ascii", "replace")
    pos += nlen
    props, pos = _read_props(data, pos, nprops)
    children = []
    while pos < end:
        child, pos = _read_node(data, pos, version)
        if child is None:
            break
        children.append(child)
    return (name, props, children), max(pos, end)


def _parse(data):
    assert data[: len(_MAGIC)] == _MAGIC, "not a binary FBX"
    (version,) = struct.unpack_from("<I", data, 23)
    pos = 27
    roots = []
    while pos < len(data):
        node, pos = _read_node(data, pos, version)
        if node is None:
            break
        roots.append(node)
    return roots, version


def _find(nodes, name):
    return [n for n in nodes if n[0] == name]


def _find1(nodes, name):
    f = _find(nodes, name)
    return f[0] if f else None


def _prop70(node, key, default=None):
    p70 = _find1(node[2], "Properties70")
    if not p70:
        return default
    for p in p70[2]:
        if p[1] and p[1][0] == key:
            vals = p[1][4:]
            return vals if len(vals) > 1 else (vals[0] if vals else default)
    return default


def _layer_values(geom_children, layer_name, value_name, index_name, n_polyverts, poly_vert_to_ctrl):
    """Resolve a layer element to per-polygon-vertex values."""
    layer = _find1(geom_children, layer_name)
    if not layer:
        return None
    ch = layer[2]
    vals = _find1(ch, value_name)
    if vals is None:
        return None
    arr = np.asarray(vals[1][0], np.float64).reshape(-1, 3 if value_name == "Normals" else 2)
    mapping = _find1(ch, "MappingInformationType")
    ref = _find1(ch, "ReferenceInformationType")
    mapping = mapping[1][0] if mapping else "ByPolygonVertex"
    ref = ref[1][0] if ref else "Direct"
    if ref == "IndexToDirect":
        idx_node = _find1(ch, index_name)
        if idx_node is not None:
            idx = np.asarray(idx_node[1][0], np.int64)
            arr = arr[np.clip(idx, 0, arr.shape[0] - 1)]
    if mapping == "ByPolygonVertex":
        return arr[:n_polyverts]
    if mapping == "ByControlPoint":
        return arr[poly_vert_to_ctrl]
    if mapping == "AllSame":
        return np.broadcast_to(arr[0], (n_polyverts, arr.shape[1]))
    return None


def _euler_xyz_deg(rx, ry, rz):
    cx, sx = np.cos(np.deg2rad(rx)), np.sin(np.deg2rad(rx))
    cy, sy = np.cos(np.deg2rad(ry)), np.sin(np.deg2rad(ry))
    cz, sz = np.cos(np.deg2rad(rz)), np.sin(np.deg2rad(rz))
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def load_fbx(path, scale=None, material_base=0):
    """Returns (parts: list[MeshPart], materials: list[MaterialDesc])."""
    with open(path, "rb") as f:
        data = f.read()
    roots, version = _parse(data)

    # unit scale: FBX native units are cm; reference GlobalScale -> metres
    settings = _find1(roots, "GlobalSettings")
    unit = 1.0
    if settings:
        u = _prop70(settings, "UnitScaleFactor", 1.0)
        unit = float(u) / 100.0
    if scale is not None:
        unit = scale

    objects = _find1(roots, "Objects")
    conns = _find1(roots, "Connections")
    geoms, models, mats_raw = {}, {}, {}
    if objects:
        for node in objects[2]:
            if node[0] == "Geometry":
                geoms[node[1][0]] = node
            elif node[0] == "Model":
                models[node[1][0]] = node
            elif node[0] == "Material":
                mats_raw[node[1][0]] = node

    # connections: child -> parents
    parents = {}
    model_mats = {}
    geo_model = {}
    if conns:
        for c in conns[2]:
            if c[0] != "C" or len(c[1]) < 3:
                continue
            kind, child, parent = c[1][0], c[1][1], c[1][2]
            if kind != "OO":
                continue
            if child in geoms and parent in models:
                geo_model[child] = parent
            elif child in mats_raw and parent in models:
                model_mats.setdefault(parent, []).append(child)
            elif child in models:
                parents[child] = parent

    def model_world(mid):
        m = np.eye(4)
        cur = mid
        seen = 0
        while cur in models and seen < 64:
            node = models[cur]
            t = np.asarray(_prop70(node, "Lcl Translation", (0.0, 0.0, 0.0)), np.float64)
            r = np.asarray(_prop70(node, "Lcl Rotation", (0.0, 0.0, 0.0)), np.float64)
            s = np.asarray(_prop70(node, "Lcl Scaling", (1.0, 1.0, 1.0)), np.float64)
            local = np.eye(4)
            local[:3, :3] = _euler_xyz_deg(*r) @ np.diag(s)
            local[:3, 3] = t
            m = local @ m
            cur = parents.get(cur, 0)
            seen += 1
        return m

    mat_ids = {}
    materials = []
    def mat_index(mid):
        if mid not in mat_ids:
            node = mats_raw.get(mid)
            diffuse = _prop70(node, "DiffuseColor", (0.8, 0.8, 0.8)) if node else (0.8, 0.8, 0.8)
            try:
                bcf = tuple(float(x) for x in diffuse[:3]) + (1.0,)
            except TypeError:
                bcf = (0.8, 0.8, 0.8, 1.0)
            mat_ids[mid] = material_base + len(materials)
            materials.append(MaterialDesc(base_color_factor=bcf))
        return mat_ids[mid]

    parts = []
    for gid, geom in geoms.items():
        ch = geom[2]
        verts_node = _find1(ch, "Vertices")
        idx_node = _find1(ch, "PolygonVertexIndex")
        if verts_node is None or idx_node is None:
            continue
        ctrl = np.asarray(verts_node[1][0], np.float64).reshape(-1, 3)
        pvi = np.asarray(idx_node[1][0], np.int64)

        # triangulate polygons (fan); negative index = ~last_vertex_of_polygon
        tri_pv = []  # indices into the polygon-vertex stream
        poly_start = 0
        for i in range(len(pvi)):
            if pvi[i] < 0:
                npoly = i - poly_start + 1
                for k in range(1, npoly - 1):
                    tri_pv += [poly_start, poly_start + k, poly_start + k + 1]
                poly_start = i + 1
        tri_pv = np.asarray(tri_pv, np.int64)
        ctrl_idx = np.where(pvi < 0, ~pvi, pvi)

        normals = _layer_values(ch, "LayerElementNormal", "Normals", "NormalsIndex",
                                len(pvi), ctrl_idx)
        uvs = _layer_values(ch, "LayerElementUV", "UV", "UVIndex", len(pvi), ctrl_idx)

        world = model_world(geo_model.get(gid, 0))
        pos = (ctrl @ world[:3, :3].T + world[:3, 3]) * unit
        # axis conversion (asset_import.cpp:121-126): swap Y/Z -> Z-up
        pos = pos[:, [0, 2, 1]]

        v_idx = ctrl_idx[tri_pv]
        P = pos[v_idx].astype(np.float32)
        if normals is not None:
            nrm_w = normals @ np.linalg.inv(world[:3, :3])
            N = nrm_w[tri_pv][:, [0, 2, 1]]
            N /= np.maximum(np.linalg.norm(N, axis=-1, keepdims=True), 1e-12)
            N = N.astype(np.float32)
        else:
            N = np.zeros_like(P)
        if uvs is not None:
            UV = uvs[tri_pv].astype(np.float32)
            UV[:, 1] = 1.0 - UV[:, 1]  # flip V (asset_import.cpp:126)
        else:
            UV = np.zeros((P.shape[0], 2), np.float32)

        # swapping two axes mirrors the winding; flip index order to preserve
        # outward orientation
        I = np.arange(P.shape[0], dtype=np.int32).reshape(-1, 3)[:, ::-1].copy()

        mid_list = model_mats.get(geo_model.get(gid, 0), [])
        mat = mat_index(mid_list[0]) if mid_list else material_base
        parts.append(MeshPart(P, N, UV, I, mat))

    if not materials:
        materials = [MaterialDesc()]
    return parts, materials
