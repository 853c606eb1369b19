"""Type-2 tap interpolation: the hand-written CUDA kernel and its plain
torch version.

Replaces the Pallas occupancy-proportional interpolation of the JAX package
(``fftvis_tpu/nufft/pallas_interp.py``, ``_build_interp_call``, driven by
``PallasInterp.__call__``), which computes

    out[c, t] = sum_a sum_b G[c, iy[t, a], ix[t, b]] * vy[t, a] * vx[t, b]

from the plan's host-computed taps (``Type3Plan.tap_idx`` / ``tap_val``,
already taken ``mod nf``). The TPU kernel bin-sorts targets into tiles and
rebuilds the taps as one-hot matrices for its matrix unit, because gathers
are slow there. On the card a gather is the natural form, and the CUDA
kernel (``csrc/interp.cu``) is shaped by where a redundant array's targets
repeat:

- :func:`target_order` sorts the targets by 32 x 32 grid tile of their
  first tap and then by that cell, so targets with the same footprint (the
  redundant baselines of an array) are neighbours; the executor keeps its
  tap tables in that order and passes the permutation as ``order`` (row k
  is target ``order[k]``, and the output stays in target order);
- :func:`footprint_runs` cuts the sorted tables into runs of rows with
  identical tap cells, at most ``RUN_CAP`` = 32 rows a run; the CUDA
  kernel takes them as ``runs``, which a CUDA call must pass;
- one warp takes one run, for all C channels. A run of four rows or more
  has its footprint gathered into shared memory once a channel, and each
  lane evaluates one target from it; a shorter run goes row by row with
  the lanes over the w x w taps and a warp reduction (the form of an array
  without redundancy, where every run is one row). Outputs are disjoint:
  no atomics, no wrap-pad.

What bounds it on the card, in bytes: the distinct grid cells the taps
touch, the tap tables and the output. At the slice's 63,190 baselines the
taps touch 0.23M cells (1.9 MB a channel at complex64, p=1) and 0.71M
cells (11.4 MB a channel at complex128, p=2); with C = 4 that is 17.6 MB
(5.2 us at 3.35 TB/s) and 71 MB (21 us). A gather of every tap would read
17x the touched cells: at p=2 the 63,190 targets have 3,716 distinct
footprints.

The interpolation is linear in G, and its adjoint with respect to G is a
scatter onto the grid: :func:`interp_adjoint` adds each target's taps,
weighted, of a (C, m) gradient into a zeroed (C, nfy, nfx) grid -- the
CUDA kernel ``interp_adjoint_runs`` on the same tables, order and runs
(one warp a run, the run's rows summed in registers, one atomic a tap and
channel) or :func:`interp_adjoint_plain` on the CPU.
:class:`InterpFunction` binds the two for autograd; :func:`interp` takes it
when G requires a gradient. ``launches`` and ``adjoint_launches`` count
the two kernels' launches.

:func:`interp_nd` interpolates a grid of any dimension d = 1, 2, 3 (the
public type-2 and type-3 transforms): d = 2 is :func:`interp`, and d = 1
and d = 3 launch ``interp_taps_nd`` (one warp a target, the lanes over the
w taps, or over the w x w taps of the last two axes with a loop over the
first, a shuffle reduction a channel), counted by ``launches_d1`` and
``launches_d3``, with :func:`interp_nd_plain` (the JAX gather and einsum)
on the CPU. Gradients at d = 1 and 3 are not ported.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

TILE = 32
RUN_CAP = 32  # rows a run at most: one a lane

launches = 0
adjoint_launches = 0
launches_d1 = 0
launches_d3 = 0


def target_order(iy0: np.ndarray, ix0: np.ndarray, tile: int = TILE) -> np.ndarray:
    """The order the kernel visits targets in: by ``tile`` x ``tile`` grid
    tile of each target's first tap cell (iy0, ix0), row-major over tiles,
    then by the cell itself, so identical targets sit together. A host
    (NumPy) permutation of range(m), int32: one stable sort of a single
    int64 key (tile, then cell), not a sort over four keys."""
    iy0 = np.asarray(iy0, dtype=np.int64)
    ix0 = np.asarray(ix0, dtype=np.int64)
    if iy0.size == 0:
        return np.zeros(0, dtype=np.int32)
    ny, nx = int(iy0.max()) + 1, int(ix0.max()) + 1
    tile_id = (iy0 // tile) * -(-nx // tile) + ix0 // tile
    key = tile_id * (ny * nx) + iy0 * nx + ix0
    return np.argsort(key, kind="stable").astype(np.int32)


def footprint_runs(iy: np.ndarray, ix: np.ndarray, cap: int = RUN_CAP) -> np.ndarray:
    """The first row of each run of rows with identical tap cells (equal
    ``iy`` and ``ix`` rows) in the tables as they are ordered, each run cut
    to at most ``cap`` rows, followed by m: a host (NumPy) int32 array of
    length nruns + 1."""
    iy, ix = np.asarray(iy), np.asarray(ix)
    m = iy.shape[0]
    new = np.ones(m, dtype=bool)
    new[1:] = np.any(iy[1:] != iy[:-1], axis=1) | np.any(ix[1:] != ix[:-1], axis=1)
    starts = np.flatnonzero(new)
    pieces = -(-np.diff(np.append(starts, m)) // cap)
    first = np.repeat(np.cumsum(pieces) - pieces, pieces)
    cut = np.repeat(starts, pieces) + (np.arange(pieces.sum()) - first) * cap
    return np.append(cut, m).astype(np.int32)


def interp_plain(G, iy, ix, vy, vx) -> torch.Tensor:
    """Plain torch interpolation: the gather + einsum of the JAX
    package's ``Type3Executor.interpolate``. Returns (C, m) complex."""
    sub = G[:, iy.long()[:, :, None], ix.long()[:, None, :]]  # (C, m, w, w)
    return torch.einsum("cmab,ma,mb->cm", sub, vy.to(G.dtype), vx.to(G.dtype))


def interp_nd_plain(G, idx, val) -> torch.Tensor:
    """Plain torch interpolation of a (C, *nf) grid of any dimension d at
    m targets: ``idx`` and ``val`` the d per-axis (m, w) tap tables, the
    gather + einsum of the JAX ``Type3Executor.interpolate``. Returns (C,
    m) complex."""
    d = len(idx)
    sub = G[(slice(None),) + tuple(
        t.long()[(slice(None),) + tuple(slice(None) if a == b else None for b in range(d))]
        for a, t in enumerate(idx))]  # (C, m, w, ..., w)
    letters = "abe"[:d]
    spec = "cm" + letters + "," + ",".join("m" + a for a in letters) + "->cm"
    return torch.einsum(spec, sub, *(v.to(G.dtype) for v in val))


def interp_adjoint_plain(g, iy, ix, vy, vx, nfy: int, nfx: int) -> torch.Tensor:
    """Plain torch adjoint of :func:`interp_plain` with respect to G: the
    (C, m) ``g``, target t's taps weighted by vy[t, a] vx[t, b], added into a
    zeroed (C, nfy, nfx) grid with ``index_add_``."""
    C, m = g.shape
    w = iy.shape[1]
    cells = (iy.long()[:, :, None] * nfx + ix.long()[:, None, :]).reshape(-1)
    wts = (vy[:, :, None] * vx[:, None, :]).reshape(m, w * w).to(g.dtype)
    contrib = (g[:, :, None] * wts[None]).reshape(C, -1)
    out = torch.zeros((C, nfy * nfx), dtype=g.dtype, device=g.device)
    torch.view_as_real(out).index_add_(1, cells, torch.view_as_real(contrib))
    return out.reshape(C, nfy, nfx)


def _check(G, iy, ix, vy, vx, order, runs) -> None:
    if not (G.device == iy.device == ix.device == vy.device == vx.device):
        raise ValueError("interp: all tensors must be on one device")
    if G.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"interp: grid must be complex64/complex128, got {G.dtype}")
    rdt = G.real.dtype
    if iy.dtype != torch.int32 or ix.dtype != torch.int32:
        raise TypeError("interp: tap indices must be int32")
    if vy.dtype != rdt or vx.dtype != rdt:
        raise TypeError(f"interp: tap values must be {rdt}, got {vy.dtype}, {vx.dtype}")
    if G.dim() != 3:
        raise ValueError(f"interp: grid must be (C, nfy, nfx), got {tuple(G.shape)}")
    if iy.dim() != 2 or iy.shape != ix.shape or iy.shape != vy.shape or vy.shape != vx.shape:
        raise ValueError("interp: tap tables must all be (m, w)")
    if not 2 <= iy.shape[1] <= 16:
        raise ValueError(f"interp: kernel width {iy.shape[1]} outside [2, 16]")
    if G.shape[1] * G.shape[2] > np.iinfo(np.int32).max:
        raise ValueError("interp: grid exceeds the int32 cell index space")
    tensors = [("G", G), ("iy", iy), ("ix", ix), ("vy", vy), ("vx", vx)]
    if order is not None:
        if order.device != G.device or order.dtype != torch.int32:
            raise TypeError("interp: order must be int32 on the grid's device")
        if order.shape != iy.shape[:1]:
            raise ValueError("interp: order must be (m,)")
        tensors.append(("order", order))
    if runs is not None:
        if runs.device != G.device or runs.dtype != torch.int32:
            raise TypeError("interp: runs must be int32 on the grid's device")
        m = iy.shape[0]
        if runs.dim() != 1 or not min(m, 1) <= runs.shape[0] - 1 <= m:
            raise ValueError("interp: runs must be (nruns + 1,) with 1 <= nruns <= m")
        tensors.append(("runs", runs))
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"interp: {name} must be contiguous")


def interp(G, iy, ix, vy, vx, order=None, runs=None) -> torch.Tensor:
    """Interpolate G (C, nfy, nfx) complex at m targets with (m, w) taps.

    With ``order`` (m,) int32, row k of the tap tables is target
    ``order[k]``: the result is (C, m) in target order all the same.
    ``runs`` is :func:`footprint_runs` of the tables as an int32 tensor on
    the grid's device. The CUDA kernel needs it and the plain version
    ignores it. The kernel clamps every run to the table's rows, so a
    malformed ``runs`` gives wrong values, never an access out of bounds.

    A CPU tensor takes :func:`interp_plain`; a CUDA tensor launches the
    CUDA kernel; any other device raises.
    """
    _check(G, iy, ix, vy, vx, order, runs)
    if torch.is_grad_enabled() and G.requires_grad:
        return InterpFunction.apply(G, iy, ix, vy, vx, order, runs)
    return _interp(G, iy, ix, vy, vx, order, runs)


def _interp(G, iy, ix, vy, vx, order, runs) -> torch.Tensor:
    if G.device.type == "cpu":
        out = interp_plain(G, iy, ix, vy, vx)
        if order is None:
            return out
        return torch.empty_like(out).index_copy_(1, order.long(), out)
    if G.device.type != "cuda":
        raise ValueError(f"interp: unsupported device {G.device}")
    if runs is None:
        raise ValueError("interp: a CUDA call needs runs (footprint_runs of the tables)")
    return _interp_cuda(G, iy, ix, vy, vx, order, runs)


def _interp_cuda(G, iy, ix, vy, vx, order, runs) -> torch.Tensor:
    global launches
    from .._build import load_kernels

    lib = load_kernels()
    C, nfy, nfx = G.shape
    m, w = iy.shape
    out = torch.empty((C, m), dtype=G.dtype, device=G.device)
    if m == 0:
        return out
    fn = lib.fftvis_interp_f32 if G.dtype == torch.complex64 else lib.fftvis_interp_f64
    err = fn(
        ctypes.c_void_p(G.data_ptr()),
        ctypes.c_void_p(iy.data_ptr()),
        ctypes.c_void_p(ix.data_ptr()),
        ctypes.c_void_p(vy.data_ptr()),
        ctypes.c_void_p(vx.data_ptr()),
        ctypes.c_void_p(runs.data_ptr()),
        ctypes.c_void_p(None if order is None else order.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        C, nfy, nfx, m, runs.shape[0] - 1, w,
        ctypes.c_void_p(torch.cuda.current_stream(G.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"interp kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def interp_adjoint(g, iy, ix, vy, vx, nf, order=None, runs=None) -> torch.Tensor:
    """The adjoint of :func:`interp` with respect to G: the (C, m) complex
    gradient ``g`` (target order) scattered through the same tap tables,
    ``order`` and ``runs`` onto a new (C, nfy, nfx) grid, ``nf`` = (nfy,
    nfx).

    A CPU tensor takes :func:`interp_adjoint_plain`; a CUDA tensor launches
    ``interp_adjoint_runs``, which needs ``runs``; any other device raises.
    """
    nfy, nfx = (int(v) for v in nf)
    g = g.contiguous()
    C, m = g.shape
    _check(g.new_empty((C, 1, 1)), iy, ix, vy, vx, order, runs)
    if g.shape[1] != iy.shape[0]:
        raise ValueError(f"interp_adjoint: gradient has {m} targets, the tables "
                         f"{iy.shape[0]}")
    if g.device.type == "cpu":
        if order is not None:
            g = g[:, order.long()]  # row k of the tables is target order[k]
        return interp_adjoint_plain(g, iy, ix, vy, vx, nfy, nfx)
    if g.device.type != "cuda":
        raise ValueError(f"interp_adjoint: unsupported device {g.device}")
    if runs is None:
        raise ValueError("interp_adjoint: a CUDA call needs runs (footprint_runs of the tables)")
    return _interp_adjoint_cuda(g, iy, ix, vy, vx, nfy, nfx, order, runs)


def _interp_adjoint_cuda(g, iy, ix, vy, vx, nfy: int, nfx: int, order, runs) -> torch.Tensor:
    global adjoint_launches
    from .._build import load_kernels

    lib = load_kernels()
    C, m = g.shape
    w = iy.shape[1]
    out = torch.zeros((C, nfy, nfx), dtype=g.dtype, device=g.device)
    if m == 0 or C == 0:
        return out
    fn = (lib.fftvis_interp_adjoint_f32 if g.dtype == torch.complex64
          else lib.fftvis_interp_adjoint_f64)
    err = fn(
        ctypes.c_void_p(g.data_ptr()),
        ctypes.c_void_p(iy.data_ptr()),
        ctypes.c_void_p(ix.data_ptr()),
        ctypes.c_void_p(vy.data_ptr()),
        ctypes.c_void_p(vx.data_ptr()),
        ctypes.c_void_p(runs.data_ptr()),
        ctypes.c_void_p(None if order is None else order.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        C, nfy, nfx, m, runs.shape[0] - 1, w,
        ctypes.c_void_p(torch.cuda.current_stream(g.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"interp_adjoint kernel launch failed: CUDA error {err}")
    adjoint_launches += 1
    return out


class InterpFunction(torch.autograd.Function):
    """:func:`interp` for autograd: ``apply(G, iy, ix, vy, vx, order,
    runs)`` -> (C, m). The gradient of G is :func:`interp_adjoint` of the
    output's gradient on the same tables; the tables get none."""

    @staticmethod
    def forward(ctx, G, iy, ix, vy, vx, order, runs):
        ctx.save_for_backward(iy, ix, vy, vx, order, runs)
        ctx.nf = tuple(G.shape[1:])
        return _interp(G, iy, ix, vy, vx, order, runs)

    @staticmethod
    def backward(ctx, g):
        iy, ix, vy, vx, order, runs = ctx.saved_tensors
        gG = interp_adjoint(g, iy, ix, vy, vx, ctx.nf, order, runs)
        return gG, None, None, None, None, None, None


def interp_nd(G, idx, val, order=None, runs=None) -> torch.Tensor:
    """Interpolate G (C, *nf) complex, d = 1, 2, 3, at m targets from the
    d per-axis (m, w) tap tables ``idx`` (int32) and ``val`` (G's real
    dtype). Returns (C, m).

    d = 2 is :func:`interp` (with its ``order`` and ``runs``). At d = 1 and
    3 the tables are in target order; a CPU tensor takes
    :func:`interp_nd_plain`, a CUDA tensor launches ``interp_taps_nd``, any
    other device raises; a grid that requires a gradient raises
    ``NotImplementedError``.
    """
    d = len(idx)
    if d == 2:
        return interp(G, idx[0], idx[1], val[0], val[1], order=order, runs=runs)
    if d not in (1, 3) or len(val) != d or G.dim() != 1 + d:
        raise ValueError(f"interp: {len(idx)} index and {len(val)} value tables for a "
                         f"grid of shape {tuple(G.shape)}")
    # The 2D checks on the first and last axes' tables and a (C, n0,
    # n_last) view of the grid's shape.
    _check(G.new_empty((G.shape[0], 1, 1)), idx[0], idx[-1], val[0], val[-1], None, None)
    if any(t.shape != idx[0].shape or t.device != G.device or not t.is_contiguous()
           for t in (*idx, *val)) or any(t.dtype != idx[0].dtype for t in idx) or any(
               v.dtype != val[0].dtype for v in val):
        raise ValueError("interp: tap tables must be matching contiguous (m, w) tensors")
    if not G.is_contiguous():
        raise ValueError("interp: G must be contiguous")
    if torch.is_grad_enabled() and G.requires_grad:
        raise NotImplementedError(f"gradients through the d={d} interpolation are "
                                  "ROADMAP item 13")
    if G.device.type == "cpu":
        return interp_nd_plain(G, idx, val)
    if G.device.type != "cuda":
        raise ValueError(f"interp: unsupported device {G.device}")
    return _interp_nd_cuda(G, idx, val)


def _interp_nd_cuda(G, idx, val) -> torch.Tensor:
    global launches_d1, launches_d3
    from .._build import load_kernels

    lib = load_kernels()
    d = len(idx)
    C = G.shape[0]
    m, w = idx[0].shape
    nf = tuple(G.shape[1:]) + (1,) * (3 - d)
    out = torch.empty((C, m), dtype=G.dtype, device=G.device)
    if m == 0:
        return out
    none = [ctypes.c_void_p(None)] * (3 - d)
    fn = lib.fftvis_interp_nd_f32 if G.dtype == torch.complex64 else lib.fftvis_interp_nd_f64
    err = fn(
        d, ctypes.c_void_p(G.data_ptr()),
        *[ctypes.c_void_p(t.data_ptr()) for t in idx], *none,
        *[ctypes.c_void_p(t.data_ptr()) for t in val], *none,
        ctypes.c_void_p(out.data_ptr()),
        C, *nf, m, w,
        ctypes.c_void_p(torch.cuda.current_stream(G.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"interp (d={d}) kernel launch failed: CUDA error {err}")
    if d == 1:
        launches_d1 += 1
    else:
        launches_d3 += 1
    return out
