"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, at first use, and ``ctypes`` loads it (no PyTorch headers in the
build, so it takes seconds, not minutes). The library lands in
``build/kernels/<hash>/libfftvis_tpu_torch.so`` at the repository root,
keyed by a hash of the sources and flags, so an edited source rebuilds.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
LIB_NAME = "libfftvis_tpu_torch.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIB = None


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the kernels if this source hash has no library yet."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # Compile to a temporary name and rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out)
    return out


def load_kernels():
    """The loaded kernel library, built on first use, with every entry
    point's argument types declared (pointers and the stream as
    ``c_void_p``: a bare Python int would be cut to 32 bits)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("fftvis_spread_f32", "fftvis_spread_f64"):
        fn = getattr(lib, name)
        # uy, ux, wts, order, starts, grid, n, C, nfy, nfx, tile, nty, ntx,
        # w, beta, group, stream
        fn.argtypes = [P] * 6 + [I] * 8 + [D, I, P]
        fn.restype = I
    for name in ("fftvis_interp_f32", "fftvis_interp_f64"):
        fn = getattr(lib, name)
        # G, iy, ix, vy, vx, out, C, nfy, nfx, m, w, stream
        fn.argtypes = [P] * 6 + [I] * 5 + [P]
        fn.restype = I
    _LIB = lib
    return lib
