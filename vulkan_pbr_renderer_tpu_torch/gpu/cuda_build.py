"""Build and load the port's CUDA kernels, and check the tensors they take.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for Hopper (sm_90a) into a shared library under `build/torch_kernels/` at the
repository root (listed in .gitignore), then loaded with ctypes.  A plain C
interface keeps PyTorch's headers out of the build, so a kernel compiles in
seconds instead of minutes.  The library name carries a hash of the source
and flags, so an edited kernel is rebuilt and a built one is reused.
The build happens at first use, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# No --use_fast_math, and no FMA contraction: the visibility kernel must round
# every product and sum exactly as its plain PyTorch version does.
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def build(name: str, defines=(), source=None):
    """Compile csrc/<name>.cu (or the file `source`, under `name`) unless an
    up-to-date library exists.  `defines` ("NAME=value" strings) become -D
    flags, for variants of a kernel's compile-time constants.

    Returns (path of the library, seconds spent compiling, nvcc/ptxas
    output); seconds is 0.0 and the output empty when nothing was built."""
    src = Path(source) if source is not None else CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    # the headers beside the source are part of what it compiles
    headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers + " ".join(flags).encode())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.cache
def load_library(name: str, defines=(), source=None) -> ctypes.CDLL:
    """Build csrc/<name>.cu or `source` (with `defines`, a tuple) if needed
    and return the loaded library."""
    path, _, _ = build(name, defines, source)
    lib = ctypes.CDLL(str(path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def error_string(lib, err: int) -> str:
    return lib.kernel_error_string(err).decode()


def query_ints(lib, fn_name, names):
    """{name: value} from the library's C function fn_name(int*, ...), which
    fills one int per name and returns a CUDA error code (raised)."""
    vals = [ctypes.c_int() for _ in names]
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * len(names)
    fn.restype = ctypes.c_int
    err = fn(*[ctypes.byref(v) for v in vals])
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} ({error_string(lib, err)})")
    return {n: v.value for n, v in zip(names, vals)}


class Epochs:
    """The epochs of a one-launch kernel's plan (shade/bloom.py's chains,
    shade/shadow.py's shafts): each launch marks its units' flags with a
    new one, so no flag is ever reset once the plan has zeroed them."""

    epoch = 0

    def next_epoch(self):
        """A mark no flag of this plan holds: 1, 2, ..., never 0."""
        self.epoch = self.epoch % 0xFFFFFFFF + 1
        return self.epoch


def need(t, what, fn, dev, shape=None, dtype=None):
    """Raise ValueError unless t is a tensor of `dtype` (default float32) on
    dev (of `shape`), contiguous where a kernel reads it (on the card)."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if not torch.is_tensor(t) or t.dtype != dtype or t.device != dev:
        got = f"{t.dtype} on {t.device}" if torch.is_tensor(t) else type(t).__name__
        raise ValueError(f"{fn}: {what} must be a {dtype} tensor on {dev}, got {got}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {what} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.is_cuda and not t.is_contiguous():
        raise ValueError(f"{fn}: {what} must be contiguous")
