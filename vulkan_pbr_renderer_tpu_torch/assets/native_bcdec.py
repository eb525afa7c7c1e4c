"""ctypes binding for the native BC decoder (native/bcdec.cpp at the
repository root; counterpart of vulkan_pbr_renderer_tpu/assets/native_bcdec.py).

Builds the shared library with g++ at first use into build/torch_native/
(listed in .gitignore), never into native/; assets/dds.py decodes with numpy
if no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
_NATIVE_DIR = os.path.join(_ROOT, "native")
_BUILD_DIR = os.path.join(_ROOT, "build", "torch_native")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.abspath(os.path.join(_NATIVE_DIR, "bcdec.cpp"))
    so = os.path.abspath(os.path.join(_BUILD_DIR, "libbcdec.so"))
    try:
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            os.makedirs(os.path.dirname(so), exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"   # a concurrent build never loads a half-written file
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        for name, nch in (("bcdec_bc1", 4), ("bcdec_bc3", 4), ("bcdec_bc5", 2)):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int,
            ]
            fn.restype = None
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def decode(fmt, raw, w, h):
    """Returns float32 [h,w,c] or None if the native path is unavailable."""
    lib = _load()
    if lib is None:
        return None
    nch = {"BC1": 4, "BC3": 4, "BC5": 2}[fmt]
    fn = {"BC1": lib.bcdec_bc1, "BC3": lib.bcdec_bc3, "BC5": lib.bcdec_bc5}[fmt]
    blocks = 8 if fmt == "BC1" else 16
    need = ((w + 3) // 4) * ((h + 3) // 4) * blocks
    if len(raw) < need:
        # truncated/malformed file: leave it to the numpy path, which raises
        # a clear ValueError (the C decoder would read out of bounds)
        return None
    buf = np.frombuffer(bytes(raw[:need]), np.uint8)
    out = np.zeros((h, w, nch), np.float32)
    fn(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        w, h,
    )
    return out
