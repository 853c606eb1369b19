"""Beam-table evaluation: the hand-written CUDA kernels and their plain
torch versions.

Replaces the Pallas beam evaluator of the JAX package
(``fftvis_tpu/beams/pallas_eval.py``, ``_build_eval_call``, driven by
``pallas_map_coordinates_cl``), which interpolates a channels-last table
``data`` (ny, nx, ch) at (npts,) fractional cell coordinates (y, x) and
returns (npts, ch):

- order 1: bilinear; y clamped to [0, ny-1]; x clamped, or periodic with
  ``wrap_x``;
- order 3: cubic B-spline on a prefiltered table
  (:func:`~fftvis_tpu_torch.beams.interp.spline_prefilter_2d`); y mirrored
  (scipy 'mirror'); x mirrored, or periodic with ``wrap_x``.

Two entries, one CUDA source (``csrc/beam_eval.cu``) with shared tap code:

- :func:`beam_eval`, the interpolation alone: one unit per (point, chunk
  of 8 channels), 16-byte vector reads; 4 threads split a unit's taps;
- :func:`beam_rows`, one source block of the engine's loop in one launch:
  the (y, x) cells from (az, za) as :func:`grid_cells` forms them, the
  interpolation, the apparent-coherency rows of
  :func:`~fftvis_tpu_torch.core.coherency.apparent_coherency_rows` and the
  horizon mask -- what the JAX engine's ``source_block_weights``
  (``fftvis_tpu/tpu/program.py``) computes for one shared tabulated beam.
  4 threads a point split its taps and add their partial channel vectors
  in registers; lane c writes row c.

A third kernel of the same source has no Pallas counterpart:
:func:`pair_rows` forms every beam pair's masked coherency rows of one
source block from K beams' evaluations (per-antenna beams: the
interpolation of a stacked table by :func:`beam_eval`, then this), what
the JAX engine does with ``apparent_coherency_rows_batched`` in XLA. Its
(P * C, n) complex output is the largest tensor of a block (180 pairs x 4
rows x 4096 points, 47 MB at complex128); the torch composition writes and
reads it about eight times, the kernel writes it once.

The TPU kernel bin-sorts points into tiles and rebuilds the taps as one-hot
matrices for its matrix unit, because gathers are slow there. On the card a
direct gather is the natural form. Cells come from an exact floor of the
raw coordinate, folded (wrap) or mirrored in integer arithmetic; ``y >=
ny-1`` reads row ``ny-1`` at order 1, as the TPU kernel and scipy do. (The
JAX gather path's float64 order-1 clip sends ``y >= ny-1`` to row
``ny-2``; the port does not copy that.)

What bounds them on the card: the table cells the taps touch (a table that
fits in L2) and the points and rows, a fraction of a microsecond at the
slice's 4096-point source blocks; a call is launch-bound, so the fused
kernel's gain is the ~17 launches of the unfused source block it replaces.
Each wrapper takes the plain version only for CPU tensors, launches its
kernel for CUDA tensors and raises on any other device; ``launches``,
``rows_launches`` and ``pair_launches`` count the kernels' launches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core.coherency import apparent_coherency_rows, apparent_coherency_rows_batched

launches = 0  # beam_eval_points launches: the interpolation alone
rows_launches = 0  # beam_rows_points launches: fused source blocks
pair_launches = 0  # pair_rows_points launches: per-antenna pair rows

TWO_PI = 2.0 * math.pi
COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}
# Epilogue codes of the fused kernel.
POWER, JONES_I, JONES_IQUV = 0, 1, 2


@dataclass(frozen=True)
class TableGrid:
    """Where a prepared table's cells lie and how its channels read.

    The table is (ny, nx, chflat) per frequency, chflat the flattened
    ``ch_shape`` = ([2 re/im,] nvec, nfeed); ``feed`` selects a power
    beam's feed.
    """

    za0: float
    dza: float
    az0: float
    daz: float
    order: int
    wrap: bool
    ch_shape: tuple
    is_complex: bool
    is_power: bool
    feed: int = 0


def _mirror(i: torch.Tensor, n: int) -> torch.Tensor:
    """scipy 'mirror' boundary index mapping (period 2n-2)."""
    if n == 1:
        return torch.zeros_like(i)
    p = 2 * n - 2
    j = torch.abs(i) % p
    return torch.where(j >= n, p - j, j)


def _bspline3_weights(t: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline weights for taps at offsets (-1, 0, 1, 2): (npts, 4)."""
    t2 = t * t
    t3 = t2 * t
    return torch.stack([
        (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0,
        (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0,
        (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0,
        t3 / 6.0,
    ], dim=-1)


def _linear_taps(u: torch.Tensor, n: int, wrap: bool):
    """Order-1 cells (npts, 2) and weights (npts, 2) along one axis."""
    if wrap:
        f = torch.floor(u)
        t = u - f
        c = torch.remainder(f.long(), n)
        idx = torch.stack([c, torch.remainder(c + 1, n)], dim=-1)
    else:
        f = torch.clamp(torch.floor(u), 0, n - 1)
        t = torch.clamp(u - f, 0.0, 1.0)
        c = f.long()
        idx = torch.stack([c, torch.clamp(c + 1, max=n - 1)], dim=-1)
    return idx, torch.stack([1.0 - t, t], dim=-1)


def _cubic_taps(u: torch.Tensor, n: int, wrap: bool):
    """Order-3 cells (npts, 4) and weights (npts, 4) along one axis."""
    f = torch.floor(u)
    cells = f.long()[:, None] + torch.arange(-1, 3, device=u.device)[None, :]
    idx = torch.remainder(cells, n) if wrap else _mirror(cells, n)
    return idx, _bspline3_weights(u - f)


def beam_eval_plain(data, y, x, order: int = 1, wrap_x: bool = False) -> torch.Tensor:
    """Plain torch evaluation: the gather + einsum of the JAX package's
    ``map_coordinates_2d_cl``. Returns (npts, ch) in ``data``'s dtype."""
    ny, nx, ch = data.shape
    taps = _linear_taps if order == 1 else _cubic_taps
    iy, wy = taps(y, ny, False)
    ix, wx = taps(x, nx, wrap_x)
    idx = iy[:, :, None] * nx + ix[:, None, :]  # (npts, K, K)
    sub = data.reshape(ny * nx, ch)[idx.reshape(-1)].reshape(idx.shape + (ch,))
    return torch.einsum("pabc,pa,pb->pc", sub, wy, wx)


def grid_cells(az, za, grid: TableGrid):
    """The fractional (y, x) table cells of (az, za) points."""
    yy = (za - grid.za0) / grid.dza
    if grid.wrap:
        # mod 2pi with the float semantics of jnp.mod; the result may
        # round to exactly 2pi, which the evaluator folds to column 0.
        r = torch.fmod(az - grid.az0, TWO_PI)
        xx = torch.where(r < 0, r + TWO_PI, r) / grid.daz
    else:
        xx = (az - grid.az0) / grid.daz
    return yy, xx


def evals_response(evals, ch_shape: tuple, is_power: bool, feed: int = 0):
    """(n, K * chflat) evaluations of K beams -> their responses, as the JAX
    package's ``BatchedPreparedBeams.evaluate_all`` gives them: (K, 2 vec,
    2 feed, n) Jones (complex for a complex table), or the selected feed's
    (K, n) real power. ``ch_shape`` is one beam's channel shape ([2 re/im,]
    nvec, nfeed), beam-major inside the channel axis."""
    n = evals.shape[0]
    vals = evals.T.reshape((-1,) + tuple(ch_shape) + (n,))
    if len(ch_shape) == 3:
        vals = torch.complex(vals[:, 0], vals[:, 1])
    if is_power:
        return vals[:, 0, min(feed, vals.shape[2] - 1)].real
    return vals


def table_response(vals, grid: TableGrid):
    """(npts, chflat) interpolated channels of one table -> the beam
    response: (2 vec, 2 feed, npts) Jones, or the selected feed's (npts,)
    real power."""
    return evals_response(vals, grid.ch_shape, grid.is_power, grid.feed)[0]


def _same_device(dev: int, *tensors) -> bool:
    return all(t.get_device() == dev for t in tensors)


def _check(data, y, x, order: int) -> None:
    if not _same_device(data.get_device(), y, x):
        raise ValueError("beam_eval: all tensors must be on one device")
    if data.dtype not in COMPLEX:
        raise TypeError(f"beam_eval: table must be float32/float64, got {data.dtype}")
    if y.dtype != data.dtype or x.dtype != data.dtype:
        raise TypeError(
            f"beam_eval: coordinates must be {data.dtype}, got {y.dtype}, {x.dtype}"
        )
    if data.dim() != 3:
        raise ValueError(f"beam_eval: table must be (ny, nx, ch), got {tuple(data.shape)}")
    if y.dim() != 1 or x.shape != y.shape:
        raise ValueError("beam_eval: y and x must be matching (npts,) vectors")
    if not data.is_contiguous():
        raise ValueError("beam_eval: table must be contiguous")
    if order not in (1, 3):
        raise ValueError(f"beam_eval: order must be 1 or 3, got {order}")


def beam_eval(data, y, x, order: int = 1, wrap_x: bool = False) -> torch.Tensor:
    """Interpolate the (ny, nx, ch) table at (npts,) cells (y, x): (npts, ch).

    A CPU tensor takes :func:`beam_eval_plain`; a CUDA tensor launches the
    CUDA kernel; any other device raises.
    """
    _check(data, y, x, order)
    if data.is_cuda:
        return _beam_eval_cuda(data, y.contiguous(), x.contiguous(), order, wrap_x)
    if data.device.type != "cpu":
        raise ValueError(f"beam_eval: unsupported device {data.device}")
    return beam_eval_plain(data, y, x, order, wrap_x)


def _epilogue(grid: TableGrid, polarized_sky: bool) -> int:
    if grid.is_power:
        return POWER
    return JONES_IQUV if polarized_sky else JONES_I


def beam_rows_plain(data, az, za, sky, mask, grid: TableGrid,
                    polarized_sky: bool = False) -> torch.Tensor:
    """Plain torch source block: :func:`grid_cells`, :func:`beam_eval_plain`,
    :func:`table_response`, ``apparent_coherency_rows``, the complex cast
    and the mask. Returns (C, n) complex rows, C = 1 (power) or 4."""
    yy, xx = grid_cells(az, za, grid)
    resp = table_response(beam_eval_plain(data, yy, xx, grid.order, grid.wrap), grid)
    rows = apparent_coherency_rows(resp, resp, sky, not grid.is_power, polarized_sky)
    return rows.to(COMPLEX[data.dtype]) * mask[None, :]


def _check_rows(data, az, za, sky, mask, grid: TableGrid, epi: int) -> None:
    if not _same_device(data.get_device(), az, za, sky, mask):
        raise ValueError("beam_rows: all tensors must be on one device")
    if data.dtype not in COMPLEX:
        raise TypeError(f"beam_rows: table must be float32/float64, got {data.dtype}")
    if data.dim() != 3 or not data.is_contiguous():
        raise ValueError(f"beam_rows: table must be a contiguous (ny, nx, ch), "
                         f"got {tuple(data.shape)}")
    n = az.shape[0]
    for name, t in (("az", az), ("za", za), ("mask", mask)):
        if t.dtype != data.dtype or t.shape != (n,):
            raise ValueError(f"beam_rows: {name} must be ({n},) {data.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if epi == JONES_IQUV:
        if sky.dtype != COMPLEX[data.dtype] or sky.shape != (n, 2, 2):
            raise ValueError(f"beam_rows: an IQUV sky must be ({n}, 2, 2) "
                             f"{COMPLEX[data.dtype]}, got {tuple(sky.shape)} {sky.dtype}")
    elif sky.dtype != data.dtype or sky.shape != (n,):
        raise ValueError(f"beam_rows: a Stokes-I sky must be ({n},) {data.dtype}, "
                         f"got {tuple(sky.shape)} {sky.dtype}")
    ch = data.shape[2]
    if math.prod(grid.ch_shape) != ch:
        raise ValueError(f"beam_rows: table has {ch} channels, the grid {grid.ch_shape}")
    if epi != POWER and ch != (8 if grid.is_complex else 4):
        raise ValueError(f"beam_rows: a Jones table has 2 x 2 channels, got {grid.ch_shape}")
    if grid.order not in (1, 3):
        raise ValueError(f"beam_rows: order must be 1 or 3, got {grid.order}")


def beam_rows(data, az, za, sky, mask, grid: TableGrid,
              polarized_sky: bool = False) -> torch.Tensor:
    """One source block's apparent-coherency rows of a tabulated beam.

    ``data`` the (ny, nx, chflat) table of one frequency laid out as
    ``grid`` says; ``az``, ``za`` and the horizon ``mask`` (n,) in its
    dtype; ``sky`` the (n,) real Stokes-I flux, or with ``polarized_sky``
    the (n, 2, 2) complex coherency, at that frequency (any strides).
    Returns (C, n) complex rows ``mask * coherency(interp(table, cells),
    sky)``: C = 1 for a power beam, else 4 ordered (00, 01, 10, 11). A
    CPU tensor takes :func:`beam_rows_plain`; a CUDA tensor launches the
    fused kernel; any other device raises.
    """
    epi = _epilogue(grid, polarized_sky)
    _check_rows(data, az, za, sky, mask, grid, epi)
    if data.is_cuda:
        return _beam_rows_cuda(data, az.contiguous(), za.contiguous(), sky,
                               mask.contiguous(), grid, epi)
    if data.device.type != "cpu":
        raise ValueError(f"beam_rows: unsupported device {data.device}")
    return beam_rows_plain(data, az, za, sky, mask, grid, polarized_sky)


def response_channels(resp, polarized: bool) -> torch.Tensor:
    """One beam's response -> its (n, chflat) evaluation channels: a (2 vec,
    2 feed, n) complex Jones response as ch_shape (2 re/im, 2, 2), an (n,)
    power response as (1, 1)."""
    if not polarized:
        return resp[:, None]
    if not resp.is_complex():
        resp = torch.complex(resp, torch.zeros_like(resp))
    return torch.stack([resp.real, resp.imag]).reshape(8, -1).T


def pair_rows_plain(evals, pair_i, pair_j, sky, mask, ch_shape: tuple, is_power: bool,
                    polarized_sky: bool = False, feed: int = 0) -> torch.Tensor:
    """Plain torch pair rows: :func:`evals_response`,
    ``apparent_coherency_rows_batched``, the complex cast and the mask.
    Returns (P * C, n) complex, C = 1 (power) or 4."""
    resp = evals_response(evals, ch_shape, is_power, feed)
    if not is_power and resp.dtype == evals.dtype:
        resp = resp.to(COMPLEX[evals.dtype])
    rows = apparent_coherency_rows_batched(resp, pair_i.cpu(), pair_j.cpu(), sky,
                                           not is_power, polarized_sky)
    return rows.to(COMPLEX[evals.dtype]) * mask[None, :]


def _check_pairs(evals, pair_i, pair_j, sky, mask, ch_shape, is_power, epi) -> None:
    if not _same_device(evals.get_device(), pair_i, pair_j, sky, mask):
        raise ValueError("pair_rows: all tensors must be on one device")
    if evals.dtype not in COMPLEX:
        raise TypeError(f"pair_rows: evaluations must be float32/float64, got {evals.dtype}")
    if evals.dim() != 2 or not evals.is_contiguous():
        raise ValueError(f"pair_rows: evaluations must be a contiguous (n, K * chflat), "
                         f"got {tuple(evals.shape)}")
    chf = math.prod(ch_shape)
    if evals.shape[1] == 0 or evals.shape[1] % chf:
        raise ValueError(f"pair_rows: {evals.shape[1]} channels are no whole number of "
                         f"beams of {tuple(ch_shape)}")
    if not is_power and tuple(ch_shape[-2:]) != (2, 2):
        raise ValueError(f"pair_rows: a Jones beam has 2 x 2 channels, got {tuple(ch_shape)}")
    for name, t in (("pair_i", pair_i), ("pair_j", pair_j)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape != pair_i.shape:
            raise ValueError(f"pair_rows: {name} must be (P,) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    n = evals.shape[0]
    if mask.dtype != evals.dtype or mask.shape != (n,):
        raise ValueError(f"pair_rows: mask must be ({n},) {evals.dtype}")
    if epi == JONES_IQUV:
        if sky.dtype != COMPLEX[evals.dtype] or sky.shape != (n, 2, 2):
            raise ValueError(f"pair_rows: an IQUV sky must be ({n}, 2, 2) "
                             f"{COMPLEX[evals.dtype]}, got {tuple(sky.shape)} {sky.dtype}")
    elif sky.dtype != evals.dtype or sky.shape != (n,):
        raise ValueError(f"pair_rows: a Stokes-I sky must be ({n},) {evals.dtype}, "
                         f"got {tuple(sky.shape)} {sky.dtype}")


def pair_rows(evals, pair_i, pair_j, sky, mask, ch_shape: tuple, is_power: bool,
              polarized_sky: bool = False, feed: int = 0) -> torch.Tensor:
    """Every beam pair's masked apparent-coherency rows of one source block.

    ``evals`` the (n, K * chflat) evaluations of K beams, beam-major inside
    the channel axis, each beam's channels laid out as ``ch_shape`` ([2
    re/im,] nvec, nfeed; a power beam's ``feed`` selected); ``pair_i``,
    ``pair_j`` the (P,) int32 beam indices of the pairs; ``sky`` the (n,)
    real Stokes-I flux, or with ``polarized_sky`` the (n, 2, 2) complex
    coherency (any strides); ``mask`` the (n,) horizon mask. Returns (P *
    C, n) complex rows, pair-major, C = 1 (power) or 4 ordered (00, 01, 10,
    11). A CPU tensor takes :func:`pair_rows_plain`; a CUDA tensor launches
    the CUDA kernel; any other device raises.
    """
    epi = POWER if is_power else (JONES_IQUV if polarized_sky else JONES_I)
    _check_pairs(evals, pair_i, pair_j, sky, mask, ch_shape, is_power, epi)
    if evals.is_cuda:
        return _pair_rows_cuda(evals, pair_i.contiguous(), pair_j.contiguous(), sky,
                               mask.contiguous(), ch_shape, epi, feed)
    if evals.device.type != "cpu":
        raise ValueError(f"pair_rows: unsupported device {evals.device}")
    return pair_rows_plain(evals, pair_i, pair_j, sky, mask, ch_shape, is_power,
                           polarized_sky, feed)


# ------------------------------------------------------------ launches

_KERNELS = None


def _kernels():
    """The ctypes entry points by (kernel, dtype), resolved once."""
    global _KERNELS
    if _KERNELS is None:
        from .._build import load_kernels

        lib = load_kernels()
        _KERNELS = {
            ("eval", torch.float32): lib.fftvis_beam_eval_f32,
            ("eval", torch.float64): lib.fftvis_beam_eval_f64,
            ("rows", torch.float32): lib.fftvis_beam_rows_f32,
            ("rows", torch.float64): lib.fftvis_beam_rows_f64,
            ("pairs", torch.float32): lib.fftvis_pair_rows_f32,
            ("pairs", torch.float64): lib.fftvis_pair_rows_f64,
        }
    return _KERNELS


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _beam_eval_cuda(data, y, x, order: int, wrap_x: bool) -> torch.Tensor:
    global launches
    k = _kernels()
    ny, nx, ch = data.shape
    npts = y.shape[0]
    out = data.new_empty((npts, ch))
    if npts == 0 or ch == 0:
        return out
    err = k[("eval", data.dtype)](
        data.data_ptr(), y.data_ptr(), x.data_ptr(), out.data_ptr(),
        npts, ny, nx, ch, order, int(bool(wrap_x)), _stream(data),
    )
    if err != 0:
        raise RuntimeError(f"beam_eval kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _beam_rows_cuda(data, az, za, sky, mask, grid: TableGrid, epi: int) -> torch.Tensor:
    global rows_launches
    k = _kernels()
    ny, nx, ch = data.shape
    n = az.shape[0]
    out = az.new_empty((1 if epi == POWER else 4, n), dtype=COMPLEX[data.dtype])
    if n == 0:
        return out
    if epi == POWER:
        # Channel (0 [re], 0 vec, feed) of chflat, as table_response reads it.
        nch, c0 = 1, min(grid.feed, grid.ch_shape[-1] - 1)
    else:
        nch, c0 = ch, 0
    # Strides in reals: a complex element is two.
    sp, sa, sb = (2 * s for s in sky.stride()) if epi == JONES_IQUV else (sky.stride(0), 0, 0)
    err = k[("rows", data.dtype)](
        data.data_ptr(), az.data_ptr(), za.data_ptr(), sky.data_ptr(),
        mask.data_ptr(), out.data_ptr(), n, ny, nx, ch, c0, grid.order,
        int(grid.wrap), epi, nch, sp, sa, sb, grid.za0, grid.dza, grid.az0,
        grid.daz, _stream(data),
    )
    if err != 0:
        raise RuntimeError(f"beam_rows kernel launch failed: CUDA error {err}")
    rows_launches += 1
    return out


def _pair_rows_cuda(evals, pair_i, pair_j, sky, mask, ch_shape: tuple, epi: int,
                    feed: int) -> torch.Tensor:
    global pair_launches
    k = _kernels()
    n = evals.shape[0]
    chf = math.prod(ch_shape)
    npairs = pair_i.shape[0]
    C = 1 if epi == POWER else 4
    out = evals.new_empty((npairs * C, n), dtype=COMPLEX[evals.dtype])
    if n == 0 or npairs == 0:
        return out
    c0 = min(feed, ch_shape[-1] - 1) if epi == POWER else 0
    # Strides in reals: a complex element is two.
    sp, sa, sb = (2 * s for s in sky.stride()) if epi == JONES_IQUV else (sky.stride(0), 0, 0)
    err = k[("pairs", evals.dtype)](
        evals.data_ptr(), pair_i.data_ptr(), pair_j.data_ptr(), sky.data_ptr(),
        mask.data_ptr(), out.data_ptr(), n, evals.shape[1] // chf, chf, c0, npairs,
        epi, int(len(ch_shape) == 3), sp, sa, sb, _stream(evals),
    )
    if err != 0:
        raise RuntimeError(f"pair_rows kernel launch failed: CUDA error {err}")
    pair_launches += 1
    return out
