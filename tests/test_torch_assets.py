"""The port's asset loaders and procedural builders against the JAX package's.

All of them are numpy on the host, so every comparison is exact: the same
file bytes give arrays that are equal bit for bit.  The files (TGA, GLB, FBX,
DDS, HDR) are written by the tests themselves; the reference's resource mount
is read only where it is present.
"""

import dataclasses
import json
import os
import struct
import zlib

import numpy as np
import pytest

from vulkan_pbr_renderer_tpu.assets import dds as jdds
from vulkan_pbr_renderer_tpu.assets import fbx as jfbx
from vulkan_pbr_renderer_tpu.assets import gltf as jgltf
from vulkan_pbr_renderer_tpu.assets import hdr as jhdr
from vulkan_pbr_renderer_tpu.assets import native_bcdec as jnative
from vulkan_pbr_renderer_tpu.assets import procedural as jproc
from vulkan_pbr_renderer_tpu.assets import tga as jtga
from vulkan_pbr_renderer_tpu_torch import assets as tassets
from vulkan_pbr_renderer_tpu_torch.app.headless import RESOURCE_DIR
from vulkan_pbr_renderer_tpu_torch.assets import dds, fbx, gltf, hdr, native_bcdec, tga
from vulkan_pbr_renderer_tpu_torch.assets import procedural as tproc
from vulkan_pbr_renderer_tpu_torch.utils import image as timage

RES = RESOURCE_DIR       # the reference's resource mount, where present


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_parts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("positions", "normals", "uvs", "indices"):
            _same(getattr(g, f), getattr(w, f))
        assert g.material == w.material


def _same_materials(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in dataclasses.fields(g):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                _same(a, b)
            else:
                assert a == b, f.name


def test_assets_package_exports():
    for name in ("MaterialDesc", "MeshPart", "Scene", "build_scene", "procedural", "scene"):
        assert hasattr(tassets, name)


# ---------------------------------------------------------------------------
# procedural builders


@pytest.mark.parametrize("args", [
    dict(), dict(center=(-7.5, 0, 1.2), radius=1.2, lat=24, lon=48, material=3),
    dict(center=(0.5, 2, -1), radius=0.3, lat=5, lon=7, material=1),
])
def test_make_uv_sphere_bit_equal(args):
    got, want = tproc.make_uv_sphere(**args), jproc.make_uv_sphere(**args)
    _same_parts([got], [want])
    lat, lon = args.get("lat", 16), args.get("lon", 32)
    assert got.indices.shape == (2 * lat * lon, 3)


@pytest.mark.parametrize("args", [dict(), dict(size=32, freq=3, amp=0.7)])
def test_bump_normal_texture_bit_equal(args):
    _same(tproc.bump_normal_texture(**args), jproc.bump_normal_texture(**args))


def test_transform_part_bit_equal():
    rng = np.random.default_rng(0)
    m = np.eye(4)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m[:3, :3] = q
    m[:3, 3] = rng.normal(size=3)
    got = tproc.transform_part(tproc.make_cube((0, 1, 2), (1, 2, 3), 4), m)
    want = jproc.transform_part(jproc.make_cube((0, 1, 2), (1, 2, 3), 4), m)
    _same_parts([got], [want])
    np.testing.assert_allclose(np.linalg.norm(got.normals, axis=1), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# BC decode: native vs numpy on synthetic blocks, and both against JAX's


def _blocks(n_bytes, seed):
    return np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("fmt,bw,bh,seed", [("BC1", 4, 3, 1), ("BC3", 4, 4, 2), ("BC5", 3, 2, 3)])
def test_bc_numpy_equals_jax(fmt, bw, bh, seed):
    raw = _blocks(bw * bh * (8 if fmt == "BC1" else 16), seed)
    fn = {"BC1": "decode_bc1", "BC3": "decode_bc3", "BC5": "decode_bc5"}[fmt]
    _same(getattr(dds, fn)(raw, bw * 4, bh * 4), getattr(jdds, fn)(raw, bw * 4, bh * 4))
    if fmt == "BC1":
        _same(dds.decode_bc4(raw, bw * 4, bh * 4), jdds.decode_bc4(raw, bw * 4, bh * 4))


@pytest.mark.parametrize("fmt,bw,bh,seed", [("BC1", 4, 3, 1), ("BC3", 4, 4, 2), ("BC5", 3, 2, 3)])
def test_bc_native_matches_numpy(fmt, bw, bh, seed):
    raw = _blocks(bw * bh * (8 if fmt == "BC1" else 16), seed)
    w, h = bw * 4, bh * 4
    ref = {"BC1": dds.decode_bc1, "BC3": dds.decode_bc3, "BC5": dds.decode_bc5}[fmt](raw, w, h)
    got = native_bcdec.decode(fmt, raw, w, h)
    if got is None:
        pytest.skip("no native compiler")
    np.testing.assert_allclose(got, ref, atol=1e-6)
    jgot = jnative.decode(fmt, raw, w, h)
    if jgot is not None:
        _same(got, jgot)


def test_native_library_builds_outside_native_dir():
    if native_bcdec._load() is None:
        pytest.skip("no native compiler")
    root = os.path.join(os.path.dirname(dds.__file__), "..", "..")
    assert os.path.exists(os.path.join(root, "build", "torch_native", "libbcdec.so"))


def test_bc1_known_block():
    # c0 = pure red (0xF800), c1 = pure blue (0x001F), c0 > c1 -> 4-color mode
    block = struct.pack("<HH", 0xF800, 0x001F) + bytes([0b01000100] * 4)
    out = dds.decode_bc1(block, 4, 4)
    np.testing.assert_allclose(out[0, 0], [1, 0, 0, 1], atol=1e-6)   # idx 0 = c0
    np.testing.assert_allclose(out[0, 1], [0, 0, 1, 1], atol=1e-6)   # idx 1 = c1


def test_bc3_color_block_always_four_color():
    # BC3's color block ignores the c0<=c1 comparison: c0 < c1 with all
    # selectors = 3 must give (c0+2*c1)/3, not black
    alpha = bytes([255, 255] + [0] * 6)
    color = struct.pack("<HH", 0x001F, 0xF800) + bytes([0xFF] * 4)
    out = dds.decode_bc3(alpha + color, 4, 4)
    expect = (np.array([0, 0, 1.0]) + 2 * np.array([1.0, 0, 0])) / 3
    np.testing.assert_allclose(out[0, 0, :3], expect, atol=1e-6)
    got = native_bcdec.decode("BC3", alpha + color, 4, 4)
    if got is not None:
        np.testing.assert_allclose(got[0, 0, :3], expect, atol=1e-6)


def test_native_decode_rejects_truncated_buffer(tmp_path):
    raw = _blocks(4 * 4 * 16, 5)
    assert native_bcdec.decode("BC3", raw[: len(raw) // 2], 16, 16) is None
    # read_dds then takes the numpy path, which raises on the short buffer
    p = tmp_path / "short.dds"
    p.write_bytes(_dds_header(16, 16, fourcc=b"DXT5") + raw[: len(raw) // 2])
    with pytest.raises(ValueError):
        dds.read_dds(str(p))


def _dds_header(w, h, fourcc=None):
    header = bytearray(128)
    header[:4] = b"DDS "
    struct.pack_into("<7I", header, 4, 124, 0x1007, h, w, w * 4, 0, 1)
    if fourcc:
        struct.pack_into("<I", header, 80, 0x4)
        header[84:88] = fourcc
    else:
        struct.pack_into("<II", header, 80, 0x41, 0)  # RGB|ALPHA
        struct.pack_into("<I", header, 88, 32)
    return bytes(header)


def test_dds_container_roundtrip(tmp_path):
    w = h = 4
    px = np.random.default_rng(0).integers(0, 255, (h, w, 4), dtype=np.uint8)
    p = tmp_path / "t.dds"
    p.write_bytes(_dds_header(w, h) + px.tobytes())
    img = dds.read_dds(str(p))
    np.testing.assert_allclose(img, px.astype(np.float32) / 255.0, atol=1e-6)
    _same(img, jdds.read_dds(str(p)))


@pytest.mark.parametrize("fourcc,nbytes", [(b"DXT1", 8), (b"DXT5", 16), (b"ATI2", 16),
                                           (b"ATI1", 8)])
@pytest.mark.parametrize("try_native", [True, False])
def test_dds_block_formats_equal_jax(tmp_path, fourcc, nbytes, try_native):
    w, h = 12, 8
    p = tmp_path / "b.dds"
    p.write_bytes(_dds_header(w, h, fourcc) + _blocks(3 * 2 * nbytes, 7))
    got = dds.read_dds(str(p), try_native=try_native)
    want = jdds.read_dds(str(p), try_native=try_native)
    assert got.shape[:2] == (h, w)
    if try_native:   # either side may have no compiler: native vs numpy is 1e-6
        np.testing.assert_allclose(got, want, atol=1e-6)
    else:
        _same(got, want)


# ---------------------------------------------------------------------------
# HDR


def _rgbe(rgb):
    m = rgb.max(-1)
    e = np.ceil(np.log2(np.maximum(m, 1e-9))).astype(np.int32) + 1
    scale = np.ldexp(1.0, -e + 8)
    out = np.zeros(rgb.shape[:2] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    out[..., 3] = (e + 128).astype(np.uint8)
    return out


def _rle_scanline(row):
    """Adaptive-RLE scanline: per channel, one run packet then literals."""
    w = row.shape[0]
    out = bytes([2, 2, w >> 8, w & 255])
    for c in range(4):
        ch = row[:, c]
        out += bytes([128 + 3, ch[0]])            # a run of 3 equal bytes
        rest = ch[3:]
        for i in range(0, len(rest), 100):
            lit = rest[i:i + 100]
            out += bytes([len(lit)]) + lit.tobytes()
    return out


@pytest.mark.parametrize("rle", [False, True], ids=["flat", "rle"])
def test_hdr_roundtrip(tmp_path, rle):
    w, h = 8, 48  # stacked cube: h == 6w
    rgb = np.random.default_rng(1).uniform(0.1, 4.0, (h, w, 3)).astype(np.float32)
    rgbe = _rgbe(rgb)
    if rle:
        rgbe[:, :3] = rgbe[:, :1]     # the run the encoder above emits
        rgb[:, :3] = rgb[:, :1]
        body = b"".join(_rle_scanline(rgbe[y]) for y in range(h))
    else:
        body = rgbe.tobytes()
    path = tmp_path / "t.hdr"
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                     + f"-Y {h} +X {w}\n".encode() + body)
    back = hdr.read_hdr(str(path))
    # RGBE quantizes each channel relative to the pixel's max component
    bound = rgb.max(-1, keepdims=True) / 100.0
    assert (np.abs(back - rgb) <= bound).all()
    cube = hdr.read_hdr_cubemap(str(path))
    assert cube.shape == (6, 8, 8, 3)
    _same(back, jhdr.read_hdr(str(path)))
    _same(cube, jhdr.read_hdr_cubemap(str(path)))


# ---------------------------------------------------------------------------
# TGA


def _tga_bytes(img, rle, top_left):
    """img uint8 [H,W,C] (C = 1, 3 or 4; RGB(A) order) -> TGA file bytes."""
    h, w, c = img.shape
    px = img[..., [2, 1, 0] + ([3] if c == 4 else [])] if c >= 3 else img
    if not top_left:
        px = px[::-1]
    px = np.ascontiguousarray(px).reshape(-1, c)
    img_type = (3 if c == 1 else 2) + (8 if rle else 0)
    head = struct.pack("<BBBHHBHHHHBB", 3, 0, img_type, 0, 0, 0, 0, 0, w, h, c * 8,
                       0x20 if top_left else 0) + b"id!"
    if not rle:
        return head + px.tobytes()
    out, i = b"", 0
    while i < len(px):
        run = 1
        while i + run < len(px) and run < 128 and (px[i + run] == px[i]).all():
            run += 1
        if run > 1:
            out += bytes([0x80 | (run - 1)]) + px[i].tobytes()
        else:
            run = min(5, len(px) - i)             # a short raw packet
            out += bytes([run - 1]) + px[i:i + run].tobytes()
        i += run
    return head + out


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
@pytest.mark.parametrize("top_left", [False, True], ids=["bottom", "top"])
def test_tga_equal_jax(tmp_path, channels, rle, top_left):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (9, 14, channels)).astype(np.uint8)
    img[2:5, 3:11] = img[2, 3]        # runs for the RLE packets
    path = tmp_path / "t.tga"
    path.write_bytes(_tga_bytes(img, rle, top_left))
    got = tga.read_tga(str(path))
    _same(got, img.astype(np.float32) / 255.0)
    _same(got, jtga.read_tga(str(path)))


# ---------------------------------------------------------------------------
# glTF: one cube, one material with an embedded PNG, a node hierarchy with TRS


def _write_glb(path):
    cube = tproc.make_cube((0, 0, 0), (2, 1, 1), 0)
    tex = (np.random.default_rng(5).integers(0, 256, (8, 8, 4))).astype(np.uint8)
    blobs = [cube.positions.tobytes(), cube.normals.tobytes(), cube.uvs.tobytes(),
             cube.indices.astype(np.uint16).tobytes(), timage.encode_png(tex)]
    views, bin_chunk = [], b""
    for b in blobs:
        views.append({"buffer": 0, "byteOffset": len(bin_chunk), "byteLength": len(b)})
        bin_chunk += b + b"\0" * (-len(b) % 4)
    nv = cube.positions.shape[0]
    js = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [
            {"children": [1], "matrix": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0.5, 0, -1, 1]},
            {"mesh": 0, "translation": [1.0, 2.0, 3.0], "scale": [1.0, 2.0, 0.5],
             "rotation": [0.0, 0.3826834, 0.0, 0.9238795]},
        ],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
                                    "indices": 3, "material": 0}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": nv, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": nv, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": nv, "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 36, "type": "SCALAR"},
        ],
        "bufferViews": views, "buffers": [{"byteLength": len(bin_chunk)}],
        "images": [{"bufferView": 4, "mimeType": "image/png"}],
        "textures": [{"source": 0}],
        "materials": [{
            "pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                     "baseColorFactor": [0.9, 0.8, 0.7, 1.0],
                                     "roughnessFactor": 0.5, "metallicFactor": 0.25},
            "normalTexture": {"index": 0}, "emissiveFactor": [0.1, 0.2, 0.3],
            "alphaMode": "MASK"}],
    }
    jb = json.dumps(js).encode()
    jb += b" " * (-len(jb) % 4)
    body = (struct.pack("<II", len(jb), 0x4E4F534A) + jb
            + struct.pack("<II", len(bin_chunk), 0x004E4942) + bin_chunk)
    path.write_bytes(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)
    return cube, tex


def test_glb_equal_jax(tmp_path):
    path = tmp_path / "cube.glb"
    cube, tex = _write_glb(path)
    parts, mats = gltf.load_glb(str(path), scale=1.5, material_base=2)
    jparts, jmats = jgltf.load_glb(str(path), scale=1.5, material_base=2)
    _same_parts(parts, jparts)
    _same_materials(mats, jmats)
    assert len(parts) == 1 and parts[0].indices.shape == (12, 3) and parts[0].material == 2
    m = mats[0]
    _same(m.base_color, tex.astype(np.float32) / 255.0)   # the PNG went through read_png
    _same(m.normal, tex[..., :2].astype(np.float32) / 255.0)
    assert m.base_color_factor == (0.9, 0.8, 0.7, 1.0) and m.orm_factor == (1.0, 0.5, 0.25)
    assert m.emissive_factor == (0.1, 0.2, 0.3) and m.alpha_test
    assert np.isfinite(parts[0].positions).all()
    np.testing.assert_allclose(np.linalg.norm(parts[0].normals, axis=1), 1.0, atol=1e-5)
    # node origin: parent translate (0.5,0,-1) + (1,2,3) = (1.5,2,2) -> Z-up (x,-z,y)
    np.testing.assert_allclose(parts[0].positions.mean(0), np.array([1.5, -2.0, 2.0]) * 1.5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# FBX: a one-mesh binary file written from the reader's record format


def _fbx_prop(v):
    if isinstance(v, str):
        b = v.encode()
        return b"S" + struct.pack("<I", len(b)) + b
    if isinstance(v, int):
        return b"L" + struct.pack("<q", v)
    if isinstance(v, float):
        return b"D" + struct.pack("<d", v)
    code = {np.dtype(np.float64): b"d", np.dtype(np.int32): b"i"}[v.dtype]
    raw = v.tobytes()
    if v.size > 16:                                   # larger arrays ride zlib
        z = zlib.compress(raw)
        return code + struct.pack("<III", v.size, 1, len(z)) + z
    return code + struct.pack("<III", v.size, 0, len(raw)) + raw


def _fbx_node(buf, name, props=(), children=()):
    start = len(buf)
    buf += b"\0" * 12 + bytes([len(name)]) + name.encode()
    pb = b"".join(_fbx_prop(p) for p in props)
    buf += pb
    for child in children:
        _fbx_node(buf, *child)
    if children:
        buf += b"\0" * 13
    struct.pack_into("<III", buf, start, len(buf), len(props), len(pb))


def _p70(*rows):
    return ("Properties70", (), [("P", (key, "", "", "") + tuple(vals)) for key, *vals in rows])


def _write_fbx(path):
    cube = tproc.make_cube((0, 0, 0), (100, 200, 50), 0)       # cm
    quads = cube.indices.reshape(6, 2, 3)
    pvi = []
    for q in quads:                                            # (a,b,c),(a,c,d) -> a b c ~d
        pvi += [int(q[0, 0]), int(q[0, 1]), int(q[0, 2]), ~int(q[1, 2])]
    pvi = np.asarray(pvi, np.int32)
    ctrl_of = np.where(pvi < 0, ~pvi, pvi)
    uv_table = np.unique(cube.uvs, axis=0).astype(np.float64)
    uv_idx = np.asarray([int(np.where((uv_table == cube.uvs[c]).all(1))[0][0])
                         for c in ctrl_of], np.int32)
    geom = ("Geometry", (1, "Geometry::cube", "Mesh"), [
        ("Vertices", (cube.positions.astype(np.float64).ravel(),)),
        ("PolygonVertexIndex", (pvi,)),
        ("LayerElementNormal", (0,), [
            ("MappingInformationType", ("ByPolygonVertex",)),
            ("ReferenceInformationType", ("Direct",)),
            ("Normals", (cube.normals[ctrl_of].astype(np.float64).ravel(),))]),
        ("LayerElementUV", (0,), [
            ("MappingInformationType", ("ByPolygonVertex",)),
            ("ReferenceInformationType", ("IndexToDirect",)),
            ("UV", (uv_table.ravel(),)), ("UVIndex", (uv_idx,))]),
    ])
    model = ("Model", (2, "Model::cube", "Mesh"), [_p70(
        ("Lcl Translation", 10.0, -20.0, 30.0), ("Lcl Rotation", 30.0, 45.0, -60.0),
        ("Lcl Scaling", 1.0, 2.0, 0.5))])
    parent = ("Model", (4, "Model::root", "Null"), [_p70(
        ("Lcl Translation", 0.0, 0.0, 100.0), ("Lcl Rotation", 0.0, 0.0, 90.0))])
    material = ("Material", (3, "Material::paint", ""), [_p70(
        ("DiffuseColor", 0.25, 0.5, 0.75))])
    buf = bytearray(b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", 7400))
    _fbx_node(buf, "GlobalSettings", (), [_p70(("UnitScaleFactor", 50.0))])
    _fbx_node(buf, "Objects", (), [geom, model, parent, material])
    _fbx_node(buf, "Connections", (), [("C", ("OO", 1, 2)), ("C", ("OO", 3, 2)),
                                        ("C", ("OO", 2, 4)), ("C", ("OO", 4, 0))])
    buf += b"\0" * 13
    path.write_bytes(bytes(buf))


@pytest.mark.parametrize("kw", [dict(), dict(scale=0.01, material_base=5)])
def test_fbx_equal_jax(tmp_path, kw):
    path = tmp_path / "cube.fbx"
    _write_fbx(path)
    parts, mats = fbx.load_fbx(str(path), **kw)
    jparts, jmats = jfbx.load_fbx(str(path), **kw)
    _same_parts(parts, jparts)
    _same_materials(mats, jmats)
    assert len(parts) == 1 and parts[0].indices.shape == (12, 3)
    assert parts[0].positions.shape == (36, 3)
    assert parts[0].material == kw.get("material_base", 0)
    assert mats[0].base_color_factor == (0.25, 0.5, 0.75, 1.0)
    np.testing.assert_allclose(np.linalg.norm(parts[0].normals, axis=1), 1.0, atol=1e-5)
    assert set(np.unique(parts[0].uvs)) == {0.0, 1.0}
    # the box's centre: parent (0,0,100) + Rz(90)(10,-20,30) = (20,10,130) cm,
    # times the unit scale, Y/Z swapped
    unit = kw.get("scale", 0.5)
    np.testing.assert_allclose(parts[0].positions.mean(0),
                               np.array([20.0, 130.0, 10.0]) * unit, atol=1e-4)


# ---------------------------------------------------------------------------
# The reference's resource mount, where present


@pytest.mark.skipif(not os.path.exists(f"{RES}/Cerberus.glb"), reason="no assets")
def test_load_cerberus():
    parts, mats = gltf.load_glb(f"{RES}/Cerberus.glb")
    assert sum(p.indices.shape[0] for p in parts) > 30000
    p = parts[0]
    assert np.isfinite(p.positions).all()
    assert abs(np.linalg.norm(p.normals, axis=1) - 1).max() < 1e-3


@pytest.mark.skipif(not os.path.exists(f"{RES}/UnitCube.glb"), reason="no assets")
def test_load_unitcube_material():
    parts, mats = gltf.load_glb(f"{RES}/UnitCube.glb")
    assert parts[0].indices.shape[0] == 12
    assert mats[0].orm_factor[1] == pytest.approx(0.5)   # roughnessFactor
    assert mats[0].orm_factor[2] == pytest.approx(0.0)   # metallicFactor


@pytest.mark.skipif(not os.path.exists(f"{RES}/Skybox_200x200x200.fbx"), reason="no assets")
def test_load_skybox_fbx():
    parts, mats = fbx.load_fbx(f"{RES}/Skybox_200x200x200.fbx")
    assert len(parts) == 1 and parts[0].indices.shape[0] == 12
    b = parts[0].positions
    np.testing.assert_allclose(b.min(0), [-100, -100, -100], atol=1e-3)
    np.testing.assert_allclose(b.max(0), [100, 100, 100], atol=1e-3)


@pytest.mark.skipif(not os.path.exists(f"{RES}/MetalRoughSpheres_Albedo.tga"),
                    reason="no assets")
def test_load_tga():
    img = tga.read_tga(f"{RES}/MetalRoughSpheres_Albedo.tga")
    assert img.shape[2] in (3, 4) and img.shape[0] == img.shape[1] == 1024
    assert 0.0 <= img.min() and img.max() <= 1.0
