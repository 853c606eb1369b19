"""Build and load the port's CUDA kernels.

At first use, one ``nvcc`` per ``csrc/*.cu`` compiles the sources in
parallel, a last ``nvcc`` links them into one shared library with a plain C
interface, and ``ctypes`` loads it (no PyTorch headers in the build, so it
takes seconds, not minutes). The library lands in
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def _check(procs) -> None:
    failed = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def build() -> Path:
    """Compile the kernels if this source hash has no library yet."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # Build in a temporary directory and rename: a concurrent or
    # interrupted build never leaves a half-written library under the
    # final name.
    tmp = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        nvcc = _nvcc()
        objs = [tmp / f"{src.stem}.o" for src in sources()]
        _check([_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
                for src, obj in zip(sources(), objs)])
        lib = tmp / LIB_NAME
        _check([_start([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)])])
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def load_kernels():
    """The loaded kernel library, built on first use, with every entry
    point's argument types declared (pointers and the stream as
    ``c_void_p``: a bare Python int would be cut to 32 bits)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    for name in ("fftvis_spread_f32", "fftvis_spread_f64"):
        fn = getattr(lib, name)
        # uy, ux, wts, grid, n, C, nfy, nfx, w, beta, stream
        fn.argtypes = [P] * 4 + [I] * 5 + [D, P]
        fn.restype = I
    for name in ("fftvis_spread_adjoint_f32", "fftvis_spread_adjoint_f64"):
        fn = getattr(lib, name)
        # uy, ux, grid gradient, out, n, C, nfy, nfx, w, beta, stream
        fn.argtypes = [P] * 4 + [I] * 5 + [D, P]
        fn.restype = I
    for name in ("fftvis_spread_nd_f32", "fftvis_spread_nd_f64"):
        fn = getattr(lib, name)
        # d, u0, u1, u2, wts, grid, n, C, n0, n1, n2, w, beta, stream
        fn.argtypes = [I] + [P] * 5 + [I] * 6 + [D, P]
        fn.restype = I
    for name in ("fftvis_interp_nd_f32", "fftvis_interp_nd_f64"):
        fn = getattr(lib, name)
        # d, G, i0, i1, i2, v0, v1, v2, out, C, n0, n1, n2, m, w, stream
        fn.argtypes = [I] + [P] * 8 + [I] * 6 + [P]
        fn.restype = I
    for name in ("fftvis_interp_f32", "fftvis_interp_f64",
                 "fftvis_interp_adjoint_f32", "fftvis_interp_adjoint_f64"):
        fn = getattr(lib, name)
        # G, iy, ix, vy, vx, runs, order, out, C, nfy, nfx, m, nruns, w,
        # stream (the adjoint: g, ..., grid gradient, ...)
        fn.argtypes = [P] * 8 + [I] * 6 + [P]
        fn.restype = I
    for name in ("fftvis_beam_eval_f32", "fftvis_beam_eval_f64"):
        fn = getattr(lib, name)
        # data, y, x, out, npts, ny, nx, ch, order, wrap, stream
        fn.argtypes = [P] * 4 + [I] * 6 + [P]
        fn.restype = I
    for name in ("fftvis_beam_eval_adjoint_f32", "fftvis_beam_eval_adjoint_f64"):
        fn = getattr(lib, name)
        # data, y, x, g, gdata, gy, gx, npts, ny, nx, ch, order, wrap, stream
        fn.argtypes = [P] * 7 + [I] * 6 + [P]
        fn.restype = I
    for name in ("fftvis_beam_rows_f32", "fftvis_beam_rows_f64"):
        fn = getattr(lib, name)
        # data, az, za, sky, mask, out, n, ny, nx, ch, c0, order, wrap, epi,
        # nch, sky strides (3), za0, dza, az0, daz, stream
        fn.argtypes = [P] * 6 + [I] * 9 + [L] * 3 + [D] * 4 + [P]
        fn.restype = I
    for name in ("fftvis_pair_rows_f32", "fftvis_pair_rows_f64"):
        fn = getattr(lib, name)
        # evals, pair_i, pair_j, sky, mask, out, n, K, chf, c0, P, epi,
        # complex, sky strides (3), stream
        fn.argtypes = [P] * 6 + [I] * 7 + [L] * 3 + [P]
        fn.restype = I
    _LIB = lib
    return lib
