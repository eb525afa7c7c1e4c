"""glTF 2.0 / GLB loader (pure python + numpy).

Replaces the assimp import path of the reference (asset_import.cpp:79-178 uses
assimp for .glb/.fbx).  Supports the subset the reference assets need:
binary GLB container, meshes with POSITION/NORMAL/TEXCOORD_0, uint16/uint32
indices, node hierarchy with transforms, and pbrMetallicRoughness materials
(factors; embedded PNG images via utils.image).  Like the reference import
(PreTransformVertices + axis flip, asset_import.cpp:89,121-126), geometry is
pre-transformed to world space and converted to the Z-up convention
(glTF is Y-up right-handed: (x, y, z) -> (x, -z, y)).

Numpy copy of vulkan_pbr_renderer_tpu/assets/gltf.py, which cannot be imported
without importing jax.
"""

from __future__ import annotations

import io
import json
import struct

import numpy as np

from .scene import MaterialDesc, MeshPart

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_SIZES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}

# glTF Y-up -> our Z-up: (x, y, z) -> (x, -z, y)
_AXIS = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)


def _read_glb(path):
    with open(path, "rb") as f:
        data = f.read()
    magic, version, _ = struct.unpack_from("<III", data, 0)
    assert magic == 0x46546C67, "not a GLB file"
    pos = 12
    js = None
    bin_chunk = b""
    while pos < len(data):
        clen, ctype = struct.unpack_from("<II", data, pos)
        chunk = data[pos + 8 : pos + 8 + clen]
        if ctype == 0x4E4F534A:
            js = json.loads(chunk)
        elif ctype == 0x004E4942:
            bin_chunk = chunk
        pos += 8 + clen
    return js, bin_chunk


def _accessor(js, bin_chunk, idx):
    acc = js["accessors"][idx]
    bv = js["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_SIZES[acc["type"]]
    count = acc["count"]
    offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride", 0)
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride and stride != itemsize:
        raw = np.frombuffer(bin_chunk, np.uint8, count * stride, offset)
        raw = raw.reshape(count, stride)[:, :itemsize].tobytes()
        arr = np.frombuffer(raw, dtype)
    else:
        arr = np.frombuffer(bin_chunk, dtype, count * ncomp, offset)
    arr = arr.reshape(count, ncomp) if ncomp > 1 else arr
    if acc.get("normalized") and dtype != np.float32:
        arr = arr.astype(np.float32) / np.iinfo(dtype).max
    return np.array(arr)


def _node_transforms(js):
    """World matrix per node (column-vector convention)."""
    nodes = js.get("nodes", [])
    mats = [None] * len(nodes)

    def local(n):
        if "matrix" in n:
            return np.array(n["matrix"], np.float32).reshape(4, 4).T
        m = np.eye(4, dtype=np.float32)
        if "scale" in n:
            m = m @ np.diag(list(n["scale"]) + [1.0]).astype(np.float32)
        if "rotation" in n:
            x, y, z, w = n["rotation"]
            r = np.array(
                [
                    [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y), 0],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x), 0],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y), 0],
                    [0, 0, 0, 1],
                ],
                np.float32,
            )
            m = r @ m
        if "translation" in n:
            t = np.eye(4, dtype=np.float32)
            t[:3, 3] = n["translation"]
            m = t @ m
        return m

    def walk(idx, parent):
        m = parent @ local(nodes[idx])
        mats[idx] = m
        for ch in nodes[idx].get("children", []):
            walk(ch, m)

    scene = js.get("scenes", [{}])[js.get("scene", 0)]
    for root in scene.get("nodes", range(len(nodes))):
        walk(root, np.eye(4, dtype=np.float32))
    for i, m in enumerate(mats):
        if m is None:
            mats[i] = np.eye(4, dtype=np.float32)
    return mats


def _decode_image(js, bin_chunk, idx):
    img = js["images"][idx]
    if "bufferView" in img:
        bv = js["bufferViews"][img["bufferView"]]
        raw = bin_chunk[bv.get("byteOffset", 0) : bv.get("byteOffset", 0) + bv["byteLength"]]
        if img.get("mimeType") == "image/png" or raw[:4] == b"\x89PNG":
            from ..utils import image as imglib

            import tempfile, os

            with tempfile.NamedTemporaryFile(suffix=".png", delete=False) as f:
                f.write(raw)
                name = f.name
            try:
                arr = imglib.read_png(name).astype(np.float32) / 255.0
            finally:
                os.unlink(name)
            return arr
    return None  # unsupported (e.g. JPEG) -> material falls back to factors


def load_glb(path, scale=1.0, material_base=0):
    """Returns (parts: list[MeshPart], materials: list[MaterialDesc]).

    Part.material indices start at material_base (for multi-asset scenes).
    """
    js, bin_chunk = _read_glb(path)
    mats_json = js.get("materials", [])
    materials = []
    for m in mats_json:
        pbr = m.get("pbrMetallicRoughness", {})
        base_tex = None
        if "baseColorTexture" in pbr:
            src = js["textures"][pbr["baseColorTexture"]["index"]].get("source")
            if src is not None:
                base_tex = _decode_image(js, bin_chunk, src)
        nrm_tex = None
        if "normalTexture" in m:
            src = js["textures"][m["normalTexture"]["index"]].get("source")
            if src is not None:
                t = _decode_image(js, bin_chunk, src)
                nrm_tex = t[..., :2] if t is not None else None
        orm_tex = None
        if "metallicRoughnessTexture" in pbr:
            src = js["textures"][pbr["metallicRoughnessTexture"]["index"]].get("source")
            if src is not None:
                orm_tex = _decode_image(js, bin_chunk, src)
        em_tex = None
        if "emissiveTexture" in m:
            src = js["textures"][m["emissiveTexture"]["index"]].get("source")
            if src is not None:
                em_tex = _decode_image(js, bin_chunk, src)
        bcf = pbr.get("baseColorFactor", [1, 1, 1, 1])
        materials.append(
            MaterialDesc(
                base_color=base_tex,
                normal=nrm_tex,
                orm=orm_tex,
                emissive=em_tex,
                base_color_factor=tuple(bcf),
                orm_factor=(1.0, pbr.get("roughnessFactor", 1.0), pbr.get("metallicFactor", 1.0)),
                emissive_factor=tuple(m.get("emissiveFactor", [0, 0, 0])),
                alpha_test=m.get("alphaMode") == "MASK",
            )
        )
    if not materials:
        materials = [MaterialDesc()]

    node_mats = _node_transforms(js)
    parts = []
    for ni, node in enumerate(js.get("nodes", [])):
        if "mesh" not in node:
            continue
        world = node_mats[ni]
        mesh = js["meshes"][node["mesh"]]
        for prim in mesh["primitives"]:
            if prim.get("mode", 4) != 4:
                continue
            attrs = prim["attributes"]
            pos = _accessor(js, bin_chunk, attrs["POSITION"]).astype(np.float32)
            nrm = (
                _accessor(js, bin_chunk, attrs["NORMAL"]).astype(np.float32)
                if "NORMAL" in attrs
                else np.zeros_like(pos)
            )
            uv = (
                _accessor(js, bin_chunk, attrs["TEXCOORD_0"]).astype(np.float32)
                if "TEXCOORD_0" in attrs
                else np.zeros((pos.shape[0], 2), np.float32)
            )
            if "indices" in prim:
                idx = _accessor(js, bin_chunk, prim["indices"]).astype(np.int64).reshape(-1, 3)
            else:
                idx = np.arange(pos.shape[0], dtype=np.int64).reshape(-1, 3)

            pos = pos @ world[:3, :3].T + world[:3, 3]
            nw = np.linalg.inv(world[:3, :3]).T
            nrm = nrm @ nw.T
            # glTF Y-up -> Z-up world
            pos = (pos @ _AXIS.T) * scale
            nrm = nrm @ _AXIS.T
            nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)

            parts.append(
                MeshPart(
                    positions=pos.astype(np.float32),
                    normals=nrm.astype(np.float32),
                    uvs=uv,
                    indices=idx.astype(np.int32),
                    material=material_base + prim.get("material", 0),
                )
            )
    return parts, materials
