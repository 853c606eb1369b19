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
weighted, of a (C, m) gradient into a (C, nfy, nfx) grid -- on the card
the kernel ``interp_adjoint_tiles``, which owns 32 x 32 grid tiles and
writes every cell once from the plan-time lists of :func:`grid_tiles`
(the footprint rectangles on each tile; no fill, no atomics), or
:func:`interp_adjoint_plain` on the CPU. :func:`interp_pairs` interpolates
the channel slices of one grid, one a beam pair, and under autograd is one
node (:class:`InterpPairsFunction`) whose backward writes one gradient;
:func:`interp` is its one-pair case. ``launches`` and ``adjoint_launches``
count the two kernels' launches.

:func:`interp_nd` interpolates a grid of any dimension d = 1, 2, 3 (the
public type-2 and type-3 transforms): d = 2 is :func:`interp`; d = 1, and
d = 3 without a bin order, launch ``interp_taps_nd`` (one warp a target,
the lanes over the w taps, or over the w x w taps of the last two axes with
a loop over the first, a shuffle reduction a channel), counted by
``launches_d1`` and ``launches_d3``. At d = 3 with the plan-time bin order
of :func:`bin_order_3d` (the executors keep it with their tap tables:
``transform.tap_tables``), ``interp_sm_3d`` runs, counted by
``launches_d3_sm``: one block a bin loads the bin's padded tile of the grid
into shared memory once, and its warps read every tap from there. The
order is planned only where every grid axis holds the padded tile, the
tables are plan tables (w consecutive cells from the first) and the
measured choice :func:`_sm_pays` finds the SM form faster (enough targets a
nonempty bin, and bins whose cells do not stay in cache); elsewhere
``interp_taps_nd`` stays. :func:`interp_nd_plain` (the JAX gather and
einsum) runs on the CPU. Gradients at d = 1 and 3 are not ported.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import numpy as np
import torch

TILE = 32
RUN_CAP = 32  # rows a run at most: one a lane

launches = 0
adjoint_launches = 0
launches_d1 = 0
launches_d3 = 0
launches_d3_sm = 0
# Targets a block of interp_sm_3d at most (a crowded bin's targets go to
# several blocks).
SUBPROBLEM = 64
# The choice of that form (:func:`_sm_pays`), by itemsize: interp_taps_nd
# reads every tap through the caches, so it wins where the cells of the
# targets' nonempty bins (a channel) are few, below SM_MIN_REGION_BYTES,
# and wherever the bins hold too few targets to repay the SM form's tile
# loads: fewer than SM_MIN_TARGETS_PER_BIN[itemsize][0] a nonempty bin
# while those cells fit the card's L2 (L2_BYTES), where a gather's hit is
# cheap, [1] past it. Each is the crossover of the two forms' times on the
# card, interpolated between the two points of chip_smoke.py phase 3's
# sweep that straddle it (PERF.md row 2b).
SM_MIN_REGION_BYTES = {4: 50 * 2**10, 8: 128 * 2**10}
L2_BYTES = 50 * 2**20
SM_MIN_TARGETS_PER_BIN = {4: (180.0, 11.5), 8: (19.0, 5.2)}


def _bins_table():
    """csrc/bins.cuh's bin rule, read from the header the kernels are built
    from: (kTileBytes, kMaxEdge, {itemsize: edges by w})."""
    text = (Path(__file__).resolve().parent.parent / "csrc" / "bins.cuh").read_text()

    def const(name):
        expr = re.search(rf"constexpr int {name} = ([0-9 *]+);", text).group(1)
        return int(np.prod([int(f) for f in expr.split("*")]))

    body = re.search(r"kBinEdge\[2\]\[17\] = \{(.*?)\n\};", text, re.S).group(1)
    rows = [[int(v) for v in r.split(",") if v.strip()]
            for r in re.findall(r"\{([0-9, ]+)\}", body)]
    return const("kTileBytes"), const("kMaxEdge"), {4: rows[0], 8: rows[1]}


TILE_BYTES, MAX_BIN_EDGE, _BIN_EDGE = _bins_table()


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


def _axis_segments(F: np.ndarray, tile: int):
    """The pieces of each run's footprint along one axis: ``F`` the (nruns,
    w) tap cells of that axis, cut where a cell is not the previous one
    plus 1 (the periodic wrap) or lies in another tile. Returns, by run
    then tap, (run, first tap, taps, tile, first cell within the tile)."""
    nr, w = F.shape
    new = np.ones((nr, w), dtype=bool)
    new[:, 1:] = (F[:, 1:] != F[:, :-1] + 1) | (F[:, 1:] // tile != F[:, :-1] // tile)
    run, a0 = np.nonzero(new)
    seg = np.cumsum(new.ravel()) - 1
    length = np.bincount(seg, minlength=run.size)
    first = F[run, a0]
    return run, a0, length, first // tile, first % tile


def grid_tiles(iy: np.ndarray, ix: np.ndarray, runs: np.ndarray, nf,
               tile: int = TILE) -> tuple[np.ndarray, np.ndarray]:
    """The owned-tile lists of ``interp_adjoint_tiles``: for every ``tile``
    x ``tile`` tile of the (nfy, nfx) grid ``nf`` (row-major over
    ceil(nfy / tile) x ceil(nfx / tile) tiles), the runs whose w x w
    footprint touches it, periodic wrap included, in run order.

    ``iy``, ``ix`` are the (m, w) host tap tables in visiting order and
    ``runs`` their :func:`footprint_runs`; a run's footprint is its first
    row's cells. Each entry is one rectangle of a run's footprint inside one
    tile: taps a0 .. a0 + na - 1 of the run's rows land on consecutive tile
    rows from ly0, taps b0 .. b0 + nb - 1 on consecutive tile columns from
    lx0 (a footprint of plan tables gives at most two pieces an axis; any
    table decomposes so). Returns (offsets int32 (ntiles + 1,), entries
    int32 (nent, 4)): entry = (first row k0, end row k1, geometry, staged
    cells before it), geometry = ly0 | lx0 << 5 | a0 << 10 | (na - 1) << 14
    | b0 << 18 | (nb - 1) << 22, staged cells the running sum of na * nb
    over the entries in list order."""
    nfy, nfx = (int(n) for n in nf)
    if tile > 32:
        raise ValueError(f"grid_tiles: tile {tile} > 32 (5 bits a local cell)")
    iy, ix = np.asarray(iy, dtype=np.int64), np.asarray(ix, dtype=np.int64)
    runs = np.asarray(runs, dtype=np.int64)
    m, w = iy.shape
    if w > 16:
        raise ValueError(f"grid_tiles: kernel width {w} > 16")
    ntx = -(-nfx // tile)
    ntiles = -(-nfy // tile) * ntx
    nonempty = np.flatnonzero(runs[:-1] < runs[1:])
    heads = runs[nonempty]  # the runs' first rows
    ys = _axis_segments(iy[heads], tile)
    xs = _axis_segments(ix[heads], tile)
    ny_run = np.bincount(ys[0], minlength=heads.size)
    nx_run = np.bincount(xs[0], minlength=heads.size)
    x_first = np.cumsum(nx_run) - nx_run
    # Every (y piece, x piece) pair of a run, by run, then y piece, then x.
    reps = nx_run[ys[0]]
    ysel = np.repeat(np.arange(ys[0].size), reps)
    xsel = x_first[ys[0][ysel]] + np.arange(reps.sum()) - np.repeat(np.cumsum(reps) - reps,
                                                                      reps)
    run = ys[0][ysel]
    tid = ys[3][ysel] * ntx + xs[3][xsel]
    geom = (ys[4][ysel] | xs[4][xsel] << 5 | ys[1][ysel] << 10 | (ys[2][ysel] - 1) << 14
            | xs[1][xsel] << 18 | (xs[2][xsel] - 1) << 22)
    size = ys[2][ysel] * xs[2][xsel]
    by_tile = np.argsort(tid, kind="stable")
    size = size[by_tile]
    cum = np.cumsum(size) - size
    if size.sum() >= 2**31:
        raise ValueError("grid_tiles: the staged cells exceed the int32 range")
    run = nonempty[run[by_tile]]
    entries = np.stack([runs[run], runs[run + 1], geom[by_tile], cum], axis=1).astype(np.int32)
    offsets = np.searchsorted(tid[by_tile], np.arange(ntiles + 1)).astype(np.int32)
    return offsets, entries


def bin_edge_3d(w: int, itemsize: int) -> int:
    """The bin edge of ``interp_sm_3d`` at width ``w`` and a real dtype of
    ``itemsize`` bytes: csrc/bins.cuh's ``kBinEdge`` entry, the largest edge
    B <= MAX_BIN_EDGE whose padded tile, (B + w - 1)^3 complex cells, fits
    TILE_BYTES."""
    return _BIN_EDGE[itemsize][w]


def _bin_keys_3d(idx, nf, edge: int) -> np.ndarray:
    """Each target's 3D bin (``edge`` cells a side, row-major) of its first
    tap cell, int64."""
    key = np.zeros(idx[0].shape[0], dtype=np.int64)
    for a, n in zip(idx, nf):
        key = key * -(-int(n) // edge) + a[:, 0].astype(np.int64) // edge
    return key


def bin_stats_3d(idx, nf, itemsize: int) -> dict:
    """What :func:`bin_order_3d`'s choice reads of the tables: the nonempty
    bins (``bins``) and their cells (``bin_cells``)."""
    edge = bin_edge_3d(idx[0].shape[1], itemsize)
    bins = int(np.unique(_bin_keys_3d(idx, nf, edge)).size)
    return {"bins": bins, "bin_cells": bins * edge**3}


def _sm_pays(m: int, bins: int, edge: int, itemsize: int) -> bool:
    """Whether ``interp_sm_3d`` is the faster form for m targets in
    ``bins`` nonempty bins of edge ``edge`` (complex cells of 2 x
    ``itemsize`` bytes)."""
    region = bins * edge**3 * 2 * itemsize
    if region < SM_MIN_REGION_BYTES[itemsize]:
        return False
    return m >= SM_MIN_TARGETS_PER_BIN[itemsize][region > L2_BYTES] * bins


def bin_order_3d(idx, nf, itemsize: int, select: bool = True):
    """The plan-time target order of ``interp_sm_3d`` for the 3 per-axis (m,
    w) tap tables ``idx`` (host NumPy, taken mod ``nf``): the targets
    ordered stably by the 3D bin (``bin_edge_3d`` cells a side, row-major)
    of their first tap cell, and the CSR offsets of the nonempty bins, each
    cut into pieces of at most SUBPROBLEM targets (one block a piece).
    Returns (perm int32 (m,), offsets int32 (npieces + 1,)), or None -- the
    tables stay for ``interp_taps_nd`` -- where a grid axis is shorter than
    the padded tile, where a table is not w consecutive cells (mod nf) from
    its first, which the kernel assumes, or, with ``select``, where
    ``interp_taps_nd`` is the faster form (:func:`_sm_pays`)."""
    m, w = idx[0].shape
    edge = bin_edge_3d(w, itemsize)
    if m == 0 or any(int(n) < edge + w - 1 for n in nf):
        return None
    steps = np.arange(w)[None, :]
    if any(not np.array_equal(np.mod(a.astype(np.int64) - a[:, :1], int(n)),
                              np.broadcast_to(steps, a.shape)) for a, n in zip(idx, nf)):
        return None
    key = _bin_keys_3d(idx, nf, edge)
    perm = np.argsort(key, kind="stable")
    ks = key[perm]
    pos = np.arange(m)
    new = np.r_[True, ks[1:] != ks[:-1]]
    if select and not _sm_pays(m, int(new.sum()), edge, itemsize):
        return None
    first = np.maximum.accumulate(np.where(new, pos, 0))
    starts = np.flatnonzero((pos - first) % SUBPROBLEM == 0)
    return perm.astype(np.int32), np.append(starts, m).astype(np.int32)


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


def interp(G, iy, ix, vy, vx, order=None, runs=None, tiles=None) -> torch.Tensor:
    """Interpolate G (C, nfy, nfx) complex at m targets with (m, w) taps.

    With ``order`` (m,) int32, row k of the tap tables is target
    ``order[k]``: the result is (C, m) in target order all the same.
    ``runs`` is :func:`footprint_runs` of the tables as an int32 tensor on
    the grid's device. The CUDA kernel needs it and the plain version
    ignores it. The kernel clamps every run to the table's rows, so a
    malformed ``runs`` gives wrong values, never an access out of bounds.
    ``tiles`` (:func:`tile_tensors`) is what a gradient of G on the card
    needs (:func:`interp_pairs`).

    A CPU tensor takes :func:`interp_plain`; a CUDA tensor launches the
    CUDA kernel; any other device raises.
    """
    return interp_pairs(G, [(0, G.shape[0], (iy, ix, vy, vx, order, runs, tiles))])[0]


def interp_pairs(G, pairs) -> list:
    """Interpolate disjoint channel slices of one grid G (C, nfy, nfx), each
    at its own targets: ``pairs`` a list of (c0, c1, tables), tables =
    (iy, ix, vy, vx, order, runs, tiles) as :func:`interp` takes them.
    Returns the (c1 - c0, m_p) outputs in that order, each slice
    interpolated as :func:`interp` does (one launch a pair on the card).

    When G requires a gradient, one autograd node covers every pair
    (:class:`InterpPairsFunction`): its backward writes one (C, nfy, nfx)
    gradient, each pair's adjoint its own channels, with no slice backward,
    no zero gradient of the whole grid and no sum. On the card that needs
    every pair's ``tiles``."""
    C = G.shape[0]
    end = 0
    for c0, c1 in sorted((c0, c1) for c0, c1, _ in pairs):
        if not end <= c0 <= c1 <= C:
            raise ValueError(f"interp: channel slices must be disjoint within [0, {C}), "
                             f"got [{c0}, {c1})")
        end = c1
    for c0, c1, tabs in pairs:
        _check(G[c0:c1], *tabs[:6])
    if torch.is_grad_enabled() and G.requires_grad:
        if G.is_cuda and any(tabs[6] is None for _, _, tabs in pairs):
            raise ValueError("interp: a gradient of the grid on the card needs every pair's "
                             "tiles (grid_tiles of its tables)")
        return list(InterpPairsFunction.apply(G, pairs))
    return [_interp(G[c0:c1], *tabs[:6]) for c0, c1, tabs in pairs]


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


def tile_tensors(iy, ix, runs, nf, device) -> tuple:
    """:func:`grid_tiles` of host tables as the int32 (offsets, entries)
    tensors ``interp_adjoint_tiles`` takes, on ``device``."""
    offsets, entries = grid_tiles(iy, ix, runs, nf)
    return (torch.tensor(offsets, dtype=torch.int32, device=device),
            torch.tensor(entries, dtype=torch.int32, device=device))


def interp_adjoint(g, iy, ix, vy, vx, nf, order=None, runs=None, tiles=None,
                   out=None) -> torch.Tensor:
    """The adjoint of :func:`interp` with respect to G: the (C, m) complex
    gradient ``g`` (target order) scattered through the same tap tables,
    ``order`` and ``runs`` onto a (C, nfy, nfx) grid, ``nf`` = (nfy, nfx):
    a new one, or ``out`` (a contiguous (C, nfy, nfx) tensor, e.g. a
    channel slice of a larger gradient), every cell of which is written.

    A CPU tensor takes :func:`interp_adjoint_plain`; a CUDA tensor launches
    ``interp_adjoint_tiles``, which needs ``tiles`` (:func:`tile_tensors`
    of the tables); any other device raises.
    """
    nfy, nfx = (int(v) for v in nf)
    g = g.contiguous()
    C, m = g.shape
    _check(g.new_empty((C, 1, 1)), iy, ix, vy, vx, order, runs)
    if g.shape[1] != iy.shape[0]:
        raise ValueError(f"interp_adjoint: gradient has {m} targets, the tables "
                         f"{iy.shape[0]}")
    if out is not None and (out.shape != (C, nfy, nfx) or out.dtype != g.dtype
                            or out.device != g.device or not out.is_contiguous()):
        raise ValueError(f"interp_adjoint: out must be a contiguous ({C}, {nfy}, {nfx}) "
                         f"{g.dtype} tensor on {g.device}")
    if g.device.type == "cpu":
        if order is not None:
            g = g[:, order.long()]  # row k of the tables is target order[k]
        grid = interp_adjoint_plain(g, iy, ix, vy, vx, nfy, nfx)
        return grid if out is None else out.copy_(grid)
    if g.device.type != "cuda":
        raise ValueError(f"interp_adjoint: unsupported device {g.device}")
    if tiles is None:
        raise ValueError("interp_adjoint: a CUDA call needs tiles (tile_tensors of the tables)")
    toff, tent = tiles
    ntiles = -(-nfy // TILE) * -(-nfx // TILE)
    for name, t, shape in (("tile offsets", toff, (ntiles + 1,)),
                           ("tile entries", tent, (tent.shape[0], 4))):
        if (t.dtype != torch.int32 or t.device != g.device or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"interp_adjoint: {name} must be a contiguous int32 {shape} "
                             f"tensor on {g.device}, got {tuple(t.shape)} {t.dtype}")
    return _interp_adjoint_cuda(g, vy, vx, nfy, nfx, order, toff, tent, out)


def _interp_adjoint_cuda(g, vy, vx, nfy: int, nfx: int, order, toff, tent, out) -> torch.Tensor:
    global adjoint_launches
    from .._build import load_kernels

    lib = load_kernels()
    C, m = g.shape
    # The kernel writes every cell: no zero pass.
    if out is None:
        out = torch.empty((C, nfy, nfx), dtype=g.dtype, device=g.device)
    if C == 0:
        return out
    fn = (lib.fftvis_interp_adjoint_f32 if g.dtype == torch.complex64
          else lib.fftvis_interp_adjoint_f64)
    err = fn(
        *[ctypes.c_void_p(None if t is None else t.data_ptr())
          for t in (g, vy, vx, order, toff, tent, out)],
        C, nfy, nfx, m, vy.shape[1], toff.shape[0] - 1, tent.shape[0],
        ctypes.c_void_p(torch.cuda.current_stream(g.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"interp_adjoint kernel launch failed: CUDA error {err}")
    adjoint_launches += 1
    return out


class InterpPairsFunction(torch.autograd.Function):
    """:func:`interp_pairs` for autograd: ``apply(G, pairs)`` -> the pairs'
    (c1 - c0, m_p) outputs. The gradient of G is one (C, nfy, nfx) tensor,
    each pair's :func:`interp_adjoint` writing its own channel slice of it
    (channels no pair reads get zeros); the tables get none."""

    @staticmethod
    def forward(ctx, G, pairs):
        ctx.pairs = pairs
        ctx.shape = tuple(G.shape)
        return tuple(_interp(G[c0:c1], *tabs[:6]) for c0, c1, tabs in pairs)

    @staticmethod
    def backward(ctx, *grads):
        C, nfy, nfx = ctx.shape
        gG = torch.empty(ctx.shape, dtype=grads[0].dtype, device=grads[0].device)
        end = 0
        for (c0, c1, tabs), g in sorted(zip(ctx.pairs, grads), key=lambda pg: pg[0][0]):
            if c0 > end:
                gG[end:c0].zero_()  # channels no pair reads (none on the engine's path)
            iy, ix, vy, vx, order, runs, tiles = tabs
            interp_adjoint(g, iy, ix, vy, vx, (nfy, nfx), order, runs, tiles, out=gG[c0:c1])
            end = c1
        if end < C:
            gG[end:].zero_()
        return gG, None


def interp_nd(G, idx, val, order=None, runs=None) -> torch.Tensor:
    """Interpolate G (C, *nf) complex, d = 1, 2, 3, at m targets from the
    d per-axis (m, w) tap tables ``idx`` (int32) and ``val`` (G's real
    dtype). Returns (C, m) in target order.

    d = 2 is :func:`interp` (with its ``order`` and ``runs``). At d = 3,
    ``order`` and ``runs`` are :func:`bin_order_3d`'s permutation and bin
    offsets as int32 tensors on G's device, the tables' rows in that order
    (row k is target ``order[k]``); without them the tables are in target
    order. A CPU tensor takes :func:`interp_nd_plain`; a CUDA tensor
    launches ``interp_sm_3d`` (d = 3 with an order) or ``interp_taps_nd``;
    any other device raises; a grid that requires a gradient raises
    ``NotImplementedError``.
    """
    d = len(idx)
    if d == 2:
        return interp(G, idx[0], idx[1], val[0], val[1], order=order, runs=runs)
    if d not in (1, 3) or len(val) != d or G.dim() != 1 + d:
        raise ValueError(f"interp: {len(idx)} index and {len(val)} value tables for a "
                         f"grid of shape {tuple(G.shape)}")
    _check_nd(G, idx, val, order, runs)
    if torch.is_grad_enabled() and G.requires_grad:
        raise NotImplementedError(f"gradients through the d={d} interpolation are "
                                  "ROADMAP item 13")
    if G.device.type == "cpu":
        out = interp_nd_plain(G, idx, val)
        if order is None:
            return out
        return torch.empty_like(out).index_copy_(1, order.long(), out)
    if G.device.type != "cuda":
        raise ValueError(f"interp: unsupported device {G.device}")
    if order is not None:
        return _interp_sm_3d(G, idx, val, order, runs)
    return _interp_nd_cuda(G, idx, val)


def _check_nd(G, idx, val, order, runs) -> None:
    """:func:`interp_nd`'s checks of the d = 1 / 3 tables, the grid and a
    d = 3 bin order."""
    dev = G.device
    if G.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"interp: grid must be complex64/complex128, got {G.dtype}")
    rdt = torch.float32 if G.dtype == torch.complex64 else torch.float64
    shape = idx[0].shape
    if len(shape) != 2:
        raise ValueError("interp: tap tables must all be (m, w)")
    if not 2 <= shape[1] <= 16:
        raise ValueError(f"interp: kernel width {shape[1]} outside [2, 16]")
    for t in idx:
        if t.device != dev:
            raise ValueError("interp: all tensors must be on one device")
        if t.dtype != torch.int32:
            raise TypeError("interp: tap indices must be int32")
    for v in val:
        if v.device != dev:
            raise ValueError("interp: all tensors must be on one device")
        if v.dtype != rdt:
            raise TypeError(f"interp: tap values must be {rdt}, got {v.dtype}")
    for t in (*idx, *val):
        if t.shape != shape or not t.is_contiguous():
            raise ValueError("interp: tap tables must be matching contiguous (m, w) tensors")
    if not G.is_contiguous():
        raise ValueError("interp: G must be contiguous")
    if (order is None) != (runs is None) or (order is not None and len(idx) != 3):
        raise ValueError("interp: a bin order (order and runs) is for d = 3 tables")
    if order is not None:
        for name, t in (("order", order), ("runs", runs)):
            if t.device != dev or t.dtype != torch.int32 or t.dim() != 1:
                raise TypeError(f"interp: {name} must be an int32 vector on the grid's device")
        if order.shape[0] != shape[0] or not 1 <= runs.shape[0] - 1 <= max(shape[0], 1):
            raise ValueError("interp: order must be (m,) and runs (nbins + 1,)")


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _interp_nd_cuda(G, idx, val) -> torch.Tensor:
    """``interp_taps_nd`` on CUDA tensors that passed :func:`_check_nd`."""
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
        C, *nf, m, w, _stream(G),
    )
    if err != 0:
        raise RuntimeError(f"interp (d={d}) kernel launch failed: CUDA error {err}")
    if d == 1:
        launches_d1 += 1
    else:
        launches_d3 += 1
    return out


def _interp_sm_3d(G, idx, val, order, runs) -> torch.Tensor:
    """``interp_sm_3d`` on CUDA tensors that passed :func:`_check_nd`, the
    tables in :func:`bin_order_3d`'s order."""
    global launches_d3_sm
    from .._build import load_kernels

    lib = load_kernels()
    C = G.shape[0]
    m, w = idx[0].shape
    out = torch.empty((C, m), dtype=G.dtype, device=G.device)
    if m == 0:
        return out
    edge = bin_edge_3d(w, 4 if G.dtype == torch.complex64 else 8)
    fn = (lib.fftvis_interp_sm_3d_f32 if G.dtype == torch.complex64
          else lib.fftvis_interp_sm_3d_f64)
    err = fn(*[ctypes.c_void_p(t.data_ptr()) for t in (G, *idx, *val, order, runs, out)],
             C, *G.shape[1:], m, runs.shape[0] - 1, w, edge, _stream(G))
    if err != 0:
        raise RuntimeError(f"interp (d=3, SM) kernel launch failed: CUDA error {err}")
    launches_d3_sm += 1
    return out
