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
``rows_launches``, ``pair_launches`` and ``pair_wide_launches`` count the
kernels' launches.

Gradients. The interpolation is linear in the table; its adjoint
(:func:`beam_eval_adjoint`, the kernel ``beam_eval_adjoint_points``, or
:func:`beam_eval_adjoint_plain`) scatters a (npts, ch) gradient into the
table with the forward's taps and, on request, gives the gradient of the
coordinates from the derivative of the tap weights; ``adjoint_launches``
counts its launches. :class:`BeamEvalFunction`, :class:`BeamRowsFunction`
and :class:`PairRowsFunction` bind the kernels for autograd, and each
wrapper takes its Function when an input it differentiates requires a
gradient. The rows are linear in the sky, so their sky gradient reruns the
forward kernel at unit skies (one for Stokes I, four for IQUV) and
contracts with the incoming gradient, ``Re(conj(R) g)`` for a real sky.
``pair_rows``' gradient in its evaluations is a kernel too
(:func:`pair_rows_adjoint`, or :func:`pair_rows_adjoint_plain`), where the
JAX package lets XLA differentiate its ops: the kernel
``pair_rows_adjoint_tile`` (a block a tile of 32 points and every beam,
the pairs' gradient rows streamed once through shared memory), or
``pair_rows_adjoint_wide`` for a stack too wide for that tile (one beam
an antenna of HERA-331). Both walk a per-beam index of the pairs
(:func:`pair_index`, built once with the engine's routing);
``pair_adjoint_launches`` and ``pair_adjoint_wide_launches`` count their
launches. The forward has the same two forms (``pair_rows_points``,
``pair_rows_wide``); host code picks the form (:func:`pair_rows_form`)
from the kernels' own shared-memory rule. ``pair_plain_cuda_calls`` counts the calls of
:func:`pair_rows_plain` on CUDA tensors, which the engine's path never
makes.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from ..core.coherency import apparent_coherency_rows, apparent_coherency_rows_batched

launches = 0  # beam_eval_points launches: the interpolation alone
rows_launches = 0  # beam_rows_points launches: fused source blocks
pair_launches = 0  # pair_rows_points launches: per-antenna pair rows
pair_wide_launches = 0  # pair_rows_wide launches: a stack too wide for the tile
adjoint_launches = 0  # beam_eval_adjoint_points launches
pair_adjoint_launches = 0  # pair_rows_adjoint_tile launches
pair_adjoint_wide_launches = 0  # pair_rows_adjoint_wide launches
pair_plain_cuda_calls = 0  # pair_rows_plain calls on CUDA tensors
# Pairs a chunk of the gradient rows that pair_rows_adjoint_tile streams
# (csrc/beam_eval.cu PA_PAIRS; :func:`pair_index` orders each beam's
# entries by it, the kernel checks it).
PAIR_ADJ_CHUNK = 16
# The forms of pair_rows and of its adjoint (csrc/beam_eval.cu PairForm),
# in the order the host tries them: the tile forms (pair_rows_points,
# pair_rows_adjoint_tile: a tile of 32 points), the wide forms
# (pair_rows_wide with a tile's rows staged in shared memory,
# pair_rows_adjoint_wide) and the forward's wide form that reads the rows
# from device memory.
PAIR_FORMS = {"tile": 0, "wide": 1, "wide-global": 2}

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
    if torch.is_grad_enabled() and (data.requires_grad or y.requires_grad or x.requires_grad):
        return BeamEvalFunction.apply(data, y, x, order, wrap_x)
    return _beam_eval(data, y, x, order, wrap_x)


def _beam_eval(data, y, x, order: int, wrap_x: bool) -> torch.Tensor:
    if data.is_cuda:
        return _beam_eval_cuda(data, y.contiguous(), x.contiguous(), order, wrap_x)
    if data.device.type != "cpu":
        raise ValueError(f"beam_eval: unsupported device {data.device}")
    return beam_eval_plain(data, y, x, order, wrap_x)


def _tap_slopes(u: torch.Tensor, n: int, wrap: bool, order: int) -> torch.Tensor:
    """d(weights)/du of the taps along one axis, (npts, K), as torch's
    autograd takes them through :func:`_linear_taps` / :func:`_cubic_taps`:
    order 1 (-1, 1), or 0 where the clamped fraction leaves [0, 1]; order
    3 the cubic B-spline weights' derivatives."""
    if order == 1:
        d = torch.ones_like(u)
        if not wrap:
            t = u - torch.clamp(torch.floor(u), 0, n - 1)
            d = ((t >= 0) & (t <= 1)).to(u.dtype)
        return torch.stack([-d, d], dim=-1)
    t = u - torch.floor(u)
    t2 = t * t
    return torch.stack([
        (-3.0 + 6.0 * t - 3.0 * t2) / 6.0,
        (-12.0 * t + 9.0 * t2) / 6.0,
        (3.0 + 6.0 * t - 9.0 * t2) / 6.0,
        3.0 * t2 / 6.0,
    ], dim=-1)


def beam_eval_adjoint_plain(data, y, x, g, order: int = 1, wrap_x: bool = False,
                            table: bool = True, coords: bool = False):
    """Plain torch adjoint of :func:`beam_eval_plain`: ``(gdata, gy, gx)``,
    the (ny, nx, ch) table gradient of the (npts, ch) output gradient ``g``
    (``index_add_`` of its tap-weighted rows; None without ``table``) and,
    with ``coords``, the (npts,) coordinate gradients from the tap weights'
    derivatives (else None). ``data`` is read only for the coordinates."""
    ny, nx, ch = data.shape
    taps = _linear_taps if order == 1 else _cubic_taps
    iy, wy = taps(y, ny, False)
    ix, wx = taps(x, nx, wrap_x)
    idx = (iy[:, :, None] * nx + ix[:, None, :]).reshape(-1)  # (npts K K,)
    gdata = gy = gx = None
    if table:
        w = (wy[:, :, None] * wx[:, None, :]).reshape(-1)
        gdata = torch.zeros((ny * nx, ch), dtype=g.dtype, device=g.device)
        gdata.index_add_(0, idx, (w[:, None] * g.repeat_interleave(wy.shape[1] ** 2, dim=0)))
        gdata = gdata.reshape(ny, nx, ch)
    if coords:
        sub = data.reshape(ny * nx, ch)[idx].reshape(iy.shape + (ix.shape[1], ch))
        dg = torch.einsum("pabc,pc->pab", sub, g)
        gy = torch.einsum("pab,pa,pb->p", dg, _tap_slopes(y, ny, False, order), wx)
        gx = torch.einsum("pab,pa,pb->p", dg, wy, _tap_slopes(x, nx, wrap_x, order))
    return gdata, gy, gx


def beam_eval_adjoint(data, y, x, g, order: int = 1, wrap_x: bool = False,
                      table: bool = True, coords: bool = False):
    """The adjoint of :func:`beam_eval`: ``(gdata, gy, gx)`` as
    :func:`beam_eval_adjoint_plain` gives them. A CPU tensor takes the
    plain version; a CUDA tensor launches ``beam_eval_adjoint_points``;
    any other device raises."""
    _check(data, y, x, order)
    if g.dtype != data.dtype or g.shape != (y.shape[0], data.shape[2]):
        raise ValueError(f"beam_eval_adjoint: gradient must be ({y.shape[0]}, "
                         f"{data.shape[2]}) {data.dtype}, got {tuple(g.shape)} {g.dtype}")
    if data.is_cuda:
        return _beam_eval_adjoint_cuda(data, y.contiguous(), x.contiguous(), g.contiguous(),
                                       order, wrap_x, table, coords)
    if data.device.type != "cpu":
        raise ValueError(f"beam_eval_adjoint: unsupported device {data.device}")
    return beam_eval_adjoint_plain(data, y, x, g, order, wrap_x, table, coords)


class BeamEvalFunction(torch.autograd.Function):
    """:func:`beam_eval` for autograd: ``apply(data, y, x, order, wrap_x)``
    -> (npts, ch). Gradients of the table and of the coordinates by
    :func:`beam_eval_adjoint`, in one launch on the card."""

    @staticmethod
    def forward(ctx, data, y, x, order, wrap_x):
        ctx.save_for_backward(data, y, x)
        ctx.order, ctx.wrap = order, wrap_x
        return _beam_eval(data, y, x, order, wrap_x)

    @staticmethod
    def backward(ctx, g):
        data, y, x = ctx.saved_tensors
        need_table = ctx.needs_input_grad[0]
        need_coords = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        gdata, gy, gx = beam_eval_adjoint(data, y, x, g, ctx.order, ctx.wrap,
                                          table=need_table, coords=need_coords)
        return gdata, gy, gx, None, None


def unit_sky_grad(rows_at, sky, g, polarized_sky: bool) -> torch.Tensor:
    """The gradient of a sky that rows are linear in: ``rows_at(s)`` reruns
    the forward at the sky ``s`` (same shape and dtype as ``sky``), and the
    result contracts with the rows' gradient ``g``: ``Re(sum_c conj(R) g)``
    at the unit Stokes-I sky, or ``sum_c conj(R_ab) g`` for each of the
    four unit (a, b) coherencies of an IQUV sky (PyTorch's convention for a
    real and a complex input)."""
    if not polarized_sky:
        r = rows_at(torch.ones_like(sky))
        return (torch.conj(r) * g).real.sum(dim=0).to(sky.dtype)
    out = torch.empty_like(sky)
    for a in range(2):
        for b in range(2):
            unit = torch.zeros_like(sky)
            unit[:, a, b] = 1
            out[:, a, b] = (torch.conj(rows_at(unit)) * g).sum(dim=0)
    return out


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (data, az, za, sky, mask)):
        return BeamRowsFunction.apply(data, az, za, sky, mask, grid, polarized_sky)
    return _beam_rows(data, az, za, sky, mask, grid, polarized_sky)


def _beam_rows(data, az, za, sky, mask, grid: TableGrid, polarized_sky: bool):
    if data.is_cuda:
        return _beam_rows_cuda(data, az.contiguous(), za.contiguous(), sky,
                               mask.contiguous(), grid, _epilogue(grid, polarized_sky))
    if data.device.type != "cpu":
        raise ValueError(f"beam_rows: unsupported device {data.device}")
    return beam_rows_plain(data, az, za, sky, mask, grid, polarized_sky)


class BeamRowsFunction(torch.autograd.Function):
    """:func:`beam_rows` for autograd, differentiable in the sky: its
    gradient reruns the fused kernel at unit skies (:func:`unit_sky_grad`).
    The table, the points and the mask are constants of the engine's
    transform path; a gradient asked of them raises."""

    @staticmethod
    def forward(ctx, data, az, za, sky, mask, grid, polarized_sky):
        if any(t.requires_grad for t in (data, az, za, mask)):
            raise NotImplementedError(
                "beam_rows differentiates the sky only; evaluate the beam "
                "(PreparedBeam.evaluate) for gradients of the table or the points")
        ctx.save_for_backward(data, az, za, sky, mask)
        ctx.grid, ctx.polarized_sky = grid, polarized_sky
        return _beam_rows(data, az, za, sky, mask, grid, polarized_sky)

    @staticmethod
    def backward(ctx, g):
        data, az, za, sky, mask = ctx.saved_tensors
        gs = unit_sky_grad(
            lambda s: _beam_rows(data, az, za, s, mask, ctx.grid, ctx.polarized_sky),
            sky, g, ctx.polarized_sky)
        return None, None, None, gs, None, None, None


def response_channels(resp, polarized: bool) -> torch.Tensor:
    """One beam's response -> its (n, chflat) evaluation channels: a (2 vec,
    2 feed, n) complex Jones response as ch_shape (2 re/im, 2, 2), an (n,)
    power response as (1, 1)."""
    if not polarized:
        return resp[:, None]
    if not resp.is_complex():
        resp = torch.complex(resp, torch.zeros_like(resp))
    return torch.stack([resp.real, resp.imag]).reshape(8, -1).T


def pair_rows_form(smem: dict) -> str:
    """The form a CUDA call of :func:`pair_rows` (or of
    :func:`pair_rows_adjoint`) takes, from ``smem``, each form's dynamic
    shared memory in bytes, -1 where the form cannot take the shapes (the
    kernels' own rule, :func:`pair_rows_smem`): the first of ``PAIR_FORMS``
    that takes them. The tile form takes every stack of the engine's paths
    but one beam an antenna; the wide form takes that (the forward's up to
    ~450 complex Jones beams, whose rows it stages); past it the forward
    reads its rows from device memory."""
    for form in PAIR_FORMS:
        if smem.get(form, -1) >= 0:
            return form
    raise ValueError(f"pair_rows: no form takes these shapes (shared memory {smem})")


@functools.lru_cache(maxsize=64)
def pair_rows_smem(adjoint: bool, nbeams: int, chf: int, npairs: int, nidx: int, C: int,
                   dtype) -> dict:
    """{form: bytes} of dynamic shared memory that each form of
    ``PAIR_FORMS`` takes for a call of :func:`pair_rows` (or, with
    ``adjoint``, of :func:`pair_rows_adjoint`) on ``nbeams`` beams of
    ``chf`` channels, ``npairs`` pairs, an index of ``nidx`` beams' offsets
    and C rows a pair in ``dtype``; -1 where the form cannot take them.
    The kernels' library answers (``fftvis_pair_rows_smem``), so this
    builds it."""
    query = _kernels()["pairs_smem"]
    return {form: query(int(adjoint), code, nbeams, chf, npairs, nidx, C,
                        int(dtype == torch.float64))
            for form, code in PAIR_FORMS.items()}


def pair_rows_plain(evals, pair_i, pair_j, sky, mask, ch_shape: tuple, is_power: bool,
                    polarized_sky: bool = False, feed: int = 0) -> torch.Tensor:
    """Plain torch pair rows: :func:`evals_response`,
    ``apparent_coherency_rows_batched``, the complex cast and the mask.
    Returns (P * C, n) complex, C = 1 (power) or 4. The pair indices stay
    on the evaluations' device (no host round trip)."""
    global pair_plain_cuda_calls
    if evals.is_cuda:
        pair_plain_cuda_calls += 1
    resp = evals_response(evals, ch_shape, is_power, feed)
    if not is_power and resp.dtype == evals.dtype:
        resp = resp.to(COMPLEX[evals.dtype])
    rows = apparent_coherency_rows_batched(resp, pair_i, pair_j, sky, not is_power,
                                           polarized_sky)
    return rows.to(COMPLEX[evals.dtype]) * mask[None, :]


def pair_index(pair_i, pair_j, nbeams: int) -> torch.Tensor:
    """The per-beam index of a pair list that :func:`pair_rows_adjoint`
    walks: (nbeams + 1 + 2P,) int32 on the pairs' device, the CSR offsets
    by beam, then each beam's entries -- entry e < P is pair e with the
    beam first (i), e >= P pair e - P with it second (j) -- first-role
    entries first, each role in the tile kernel's chunk order: pair p in
    chunk p % nch, slot p // nch (nch = ceil(P / PAIR_ADJ_CHUNK)), so that
    an owner walks its entries chunk by chunk. Indices are clamped into
    [0, nbeams) as the kernels clamp them. Torch ops, no host sync; the
    engine builds it once with its routing."""
    keys = torch.cat([pair_i, pair_j]).long().clamp(0, max(nbeams - 1, 0))
    npairs = pair_i.shape[0]
    nch = max(1, -(-npairs // PAIR_ADJ_CHUNK))
    e = torch.arange(2 * npairs, device=keys.device)
    role = (e >= npairs).long()
    p = e - role * npairs
    order = ((keys * 2 + role) * nch + p % nch) * PAIR_ADJ_CHUNK + p // nch
    entries = torch.sort(order).indices
    off = torch.zeros(nbeams + 1, dtype=torch.long, device=keys.device)
    off.index_add_(0, keys + 1, torch.ones_like(keys))
    return torch.cat([off.cumsum(0), entries]).to(torch.int32)


def pair_rows_adjoint_plain(evals, pair_i, pair_j, sky, mask, g, ch_shape: tuple,
                            is_power: bool, polarized_sky: bool = False,
                            feed: int = 0) -> torch.Tensor:
    """Plain torch adjoint of :func:`pair_rows_plain` in its evaluations:
    the (n, K * chf) gradient of ``Re sum conj(g) rows`` for the (P * C, n)
    complex ``g`` (PyTorch's convention for a complex output), the autograd
    of the plain rows. A power row's slope is zero where e_i e_j <= 0
    (``_sqrt_floor``). The sky and the mask are constants."""
    with torch.enable_grad():
        ev = evals.detach().requires_grad_()
        rows = pair_rows_plain(ev, pair_i, pair_j, sky.detach(), mask.detach(), ch_shape,
                               is_power, polarized_sky, feed)
        (gev,) = torch.autograd.grad(rows, ev, g)
    return gev


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
              polarized_sky: bool = False, feed: int = 0, index=None) -> torch.Tensor:
    """Every beam pair's masked apparent-coherency rows of one source block.

    ``evals`` the (n, K * chflat) evaluations of K beams, beam-major inside
    the channel axis, each beam's channels laid out as ``ch_shape`` ([2
    re/im,] nvec, nfeed; a power beam's ``feed`` selected); ``pair_i``,
    ``pair_j`` the (P,) int32 beam indices of the pairs; ``sky`` the (n,)
    real Stokes-I flux, or with ``polarized_sky`` the (n, 2, 2) complex
    coherency (any strides); ``mask`` the (n,) horizon mask. Returns (P *
    C, n) complex rows, pair-major, C = 1 (power) or 4 ordered (00, 01, 10,
    11). A CPU tensor takes :func:`pair_rows_plain`; a CUDA tensor launches
    the CUDA kernel in the form :func:`pair_rows_form` picks; any other
    device raises. ``index``, the pairs'
    :func:`pair_index`, serves a gradient in the evaluations on the card
    (built there when not given).
    """
    epi = POWER if is_power else (JONES_IQUV if polarized_sky else JONES_I)
    _check_pairs(evals, pair_i, pair_j, sky, mask, ch_shape, is_power, epi)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (evals, sky, mask)):
        return PairRowsFunction.apply(evals, pair_i, pair_j, sky, mask, ch_shape, is_power,
                                      polarized_sky, feed, index)
    return _pair_rows(evals, pair_i, pair_j, sky, mask, ch_shape, is_power, polarized_sky,
                      feed)


def _pair_rows(evals, pair_i, pair_j, sky, mask, ch_shape: tuple, is_power: bool,
               polarized_sky: bool, feed: int) -> torch.Tensor:
    if evals.is_cuda:
        epi = POWER if is_power else (JONES_IQUV if polarized_sky else JONES_I)
        return _pair_rows_cuda(evals, pair_i.contiguous(), pair_j.contiguous(), sky,
                               mask.contiguous(), ch_shape, epi, feed)
    if evals.device.type != "cpu":
        raise ValueError(f"pair_rows: unsupported device {evals.device}")
    return pair_rows_plain(evals, pair_i, pair_j, sky, mask, ch_shape, is_power,
                           polarized_sky, feed)


def pair_rows_adjoint(evals, pair_i, pair_j, sky, mask, g, ch_shape: tuple, is_power: bool,
                      polarized_sky: bool = False, feed: int = 0, index=None) -> torch.Tensor:
    """The adjoint of :func:`pair_rows` in its evaluations: the (n, K *
    chf) gradient for the rows' (P * C, n) complex gradient ``g``, as
    :func:`pair_rows_adjoint_plain` gives it. A CPU tensor takes the plain
    version; a CUDA tensor launches ``pair_rows_adjoint_tile`` (or, for a
    stack too wide for its tile, ``pair_rows_adjoint_wide``: the form
    :func:`pair_rows_form` picks) on the pairs' :func:`pair_index`
    ``index`` (built when not given); any other device raises."""
    epi = POWER if is_power else (JONES_IQUV if polarized_sky else JONES_I)
    _check_pairs(evals, pair_i, pair_j, sky, mask, ch_shape, is_power, epi)
    want = (pair_i.shape[0] * (1 if is_power else 4), evals.shape[0])
    if g.dtype != COMPLEX[evals.dtype] or tuple(g.shape) != want:
        raise ValueError(f"pair_rows_adjoint: gradient must be {want} {COMPLEX[evals.dtype]}, "
                         f"got {tuple(g.shape)} {g.dtype}")
    if evals.is_cuda:
        K = evals.shape[1] // math.prod(ch_shape)
        if index is None:
            index = pair_index(pair_i, pair_j, K)
        nidx = index.shape[0] - 1 - 2 * pair_i.shape[0]
        if (index.dtype != torch.int32 or index.dim() != 1 or not 0 <= nidx <= K
                or index.device != evals.device):
            raise ValueError(f"pair_rows_adjoint: index must be a pair_index of these pairs "
                             f"and at most {K} beams on {evals.device}")
        return _pair_rows_adjoint_cuda(evals, pair_i.contiguous(), pair_j.contiguous(),
                                       index.contiguous(), sky, mask.contiguous(),
                                       g.contiguous(), ch_shape, epi, feed, nidx)
    if evals.device.type != "cpu":
        raise ValueError(f"pair_rows_adjoint: unsupported device {evals.device}")
    return pair_rows_adjoint_plain(evals, pair_i, pair_j, sky, mask, g, ch_shape, is_power,
                                   polarized_sky, feed)


class PairRowsFunction(torch.autograd.Function):
    """:func:`pair_rows` for autograd: the sky's gradient reruns the kernel
    at unit skies (:func:`unit_sky_grad`), the evaluations' is
    :func:`pair_rows_adjoint` (rows are bilinear in them). The pair indices
    and the mask are constants; a gradient asked of the mask raises."""

    @staticmethod
    def forward(ctx, evals, pair_i, pair_j, sky, mask, ch_shape, is_power, polarized_sky,
                feed, index):
        if mask.requires_grad:
            raise NotImplementedError("pair_rows does not differentiate the mask")
        ctx.save_for_backward(evals, pair_i, pair_j, sky, mask)
        ctx.args = (ch_shape, is_power, polarized_sky, feed)
        ctx.index = index
        return _pair_rows(evals, pair_i, pair_j, sky, mask, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        evals, pair_i, pair_j, sky, mask = ctx.saved_tensors
        gev = gs = None
        if ctx.needs_input_grad[0]:
            gev = pair_rows_adjoint(evals, pair_i, pair_j, sky, mask, g, *ctx.args,
                                    index=ctx.index)
        if ctx.needs_input_grad[3]:
            gs = unit_sky_grad(
                lambda s: _pair_rows(evals, pair_i, pair_j, s, mask, *ctx.args),
                sky, g, ctx.args[2])
        return gev, None, None, gs, None, None, None, None, None, None


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
            ("eval_adjoint", torch.float32): lib.fftvis_beam_eval_adjoint_f32,
            ("eval_adjoint", torch.float64): lib.fftvis_beam_eval_adjoint_f64,
            ("rows", torch.float32): lib.fftvis_beam_rows_f32,
            ("rows", torch.float64): lib.fftvis_beam_rows_f64,
            ("pairs", torch.float32): lib.fftvis_pair_rows_f32,
            ("pairs", torch.float64): lib.fftvis_pair_rows_f64,
            ("pairs_adjoint", torch.float32): lib.fftvis_pair_rows_adjoint_f32,
            ("pairs_adjoint", torch.float64): lib.fftvis_pair_rows_adjoint_f64,
            "eval_adjoint_scratch": lib.fftvis_beam_eval_adjoint_scratch,
            "pairs_smem": lib.fftvis_pair_rows_smem,
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


def _beam_eval_adjoint_cuda(data, y, x, g, order: int, wrap_x: bool, table: bool,
                            coords: bool):
    global adjoint_launches
    k = _kernels()
    ny, nx, ch = data.shape
    npts = y.shape[0]
    if npts == 0 or ch == 0 or not (table or coords):
        return (torch.zeros_like(data) if table else None,
                torch.zeros_like(y) if coords else None, torch.zeros_like(x) if coords else None)
    # The kernel writes every entry of what it returns: no zero pass.
    gdata = torch.empty_like(data) if table else None
    scratch = None
    if table:
        scratch = torch.empty(k["eval_adjoint_scratch"](npts, ny, nx, order), dtype=torch.int32,
                              device=data.device)
    gy = torch.empty_like(y) if coords else None
    gx = torch.empty_like(x) if coords else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = k[("eval_adjoint", data.dtype)](
        data.data_ptr(), y.data_ptr(), x.data_ptr(), g.data_ptr(), ptr(gdata), ptr(gy),
        ptr(gx), ptr(scratch), npts, ny, nx, ch, order, int(bool(wrap_x)), _stream(data),
    )
    if err != 0:
        raise RuntimeError(f"beam_eval_adjoint kernel launch failed: CUDA error {err}")
    adjoint_launches += 1
    return gdata, gy, gx


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


def _pick_form(form, smem: dict, what: str) -> int:
    """The form code of a CUDA launch: the rule's pick from ``smem``
    (:func:`pair_rows_smem`), or ``form`` (a name of ``PAIR_FORMS``, which
    the checks ask for); a form that cannot take the shapes raises."""
    if form is None:
        return PAIR_FORMS[pair_rows_form(smem)]
    if smem.get(form, -1) < 0:
        raise ValueError(f"{what}: the {form!r} form cannot take these shapes (shared memory "
                         f"{smem})")
    return PAIR_FORMS[form]


def _pair_rows_cuda(evals, pair_i, pair_j, sky, mask, ch_shape: tuple, epi: int,
                    feed: int, form: str | None = None) -> torch.Tensor:
    """The CUDA launch of :func:`pair_rows`, in the form the rule picks
    or in ``form`` (the checks' way to time and test every form)."""
    global pair_launches, pair_wide_launches
    k = _kernels()
    n = evals.shape[0]
    chf = math.prod(ch_shape)
    npairs = pair_i.shape[0]
    C = 1 if epi == POWER else 4
    K = evals.shape[1] // chf
    code = _pick_form(form, pair_rows_smem(False, K, chf, npairs, K, C, evals.dtype),
                      "pair_rows")
    out = evals.new_empty((npairs * C, n), dtype=COMPLEX[evals.dtype])
    if n == 0 or npairs == 0:
        return out
    c0 = min(feed, ch_shape[-1] - 1) if epi == POWER else 0
    # Strides in reals: a complex element is two.
    sp, sa, sb = (2 * s for s in sky.stride()) if epi == JONES_IQUV else (sky.stride(0), 0, 0)
    err = k[("pairs", evals.dtype)](
        evals.data_ptr(), pair_i.data_ptr(), pair_j.data_ptr(), sky.data_ptr(),
        mask.data_ptr(), out.data_ptr(), n, K, chf, c0, npairs,
        epi, int(len(ch_shape) == 3), code, sp, sa, sb, _stream(evals),
    )
    if err != 0:
        raise RuntimeError(f"pair_rows kernel launch failed: CUDA error {err}")
    if code == PAIR_FORMS["tile"]:
        pair_launches += 1
    else:
        pair_wide_launches += 1
    return out


def _pair_rows_adjoint_cuda(evals, pair_i, pair_j, index, sky, mask, g, ch_shape: tuple,
                            epi: int, feed: int, nidx: int,
                            form: str | None = None) -> torch.Tensor:
    """The CUDA launch of :func:`pair_rows_adjoint`, in the form the rule
    picks or in ``form`` (the checks' way to test every form)."""
    global pair_adjoint_launches, pair_adjoint_wide_launches
    k = _kernels()
    n = evals.shape[0]
    chf = math.prod(ch_shape)
    K = evals.shape[1] // chf
    smem = pair_rows_smem(True, K, chf, pair_i.shape[0], nidx, 1 if epi == POWER else 4,
                          evals.dtype)
    code = _pick_form(form, smem, "pair_rows_adjoint")
    out = torch.empty_like(evals)  # the kernel writes every entry
    if n == 0:
        return out
    c0 = min(feed, ch_shape[-1] - 1) if epi == POWER else 0
    # Strides in reals: a complex element is two.
    sp, sa, sb = (2 * s for s in sky.stride()) if epi == JONES_IQUV else (sky.stride(0), 0, 0)
    err = k[("pairs_adjoint", evals.dtype)](
        evals.data_ptr(), pair_i.data_ptr(), pair_j.data_ptr(), index.data_ptr(),
        sky.data_ptr(), mask.data_ptr(), g.data_ptr(), out.data_ptr(), n,
        K, chf, c0, pair_i.shape[0], nidx, epi, int(len(ch_shape) == 3),
        PAIR_ADJ_CHUNK, code, sp, sa, sb, _stream(evals),
    )
    if err != 0:
        raise RuntimeError(f"pair_rows_adjoint kernel launch failed: CUDA error {err}")
    if code == PAIR_FORMS["tile"]:
        pair_adjoint_launches += 1
    else:
        pair_adjoint_wide_launches += 1
    return out
