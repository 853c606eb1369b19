"""ES spreading: the hand-written CUDA kernels and their plain torch versions.

Replaces the Pallas band-accumulator spreader of the JAX package
(``fftvis_tpu/nufft/pallas_spread.py``, ``_build_pallas_call``, driven by
``spread_pallas_tiled``), which computes

    g[c, y, x] += sum_j psi(y - uy_j) psi(x - ux_j) w[c, j]

on the periodic (C, nfy, nfx) fine grid. The CUDA kernel
(``csrc/spread.cu``) is cuFINUFFT's GM method (arXiv 2102.08463), chosen
for the slice's low density (4096 sources on a 4320 x 3072 grid, 3e-4 a
cell): one warp a source evaluates the 2w ES kernel values once and adds
its w x w taps, for every channel, straight into the global grid with
atomics at ``(y mod nfy, x mod nfx)``. That replaces the TPU kernel's band
overlap-add and periodic fold. A source whose weights are all exactly zero
(the horizon mask) adds nothing and is skipped. There is no pre-pass: the
sources run in the order given.

What bounds it on the card, in bytes: the touched grid cells read and
written once, plus coordinates and weights. At the slice's blocks, C = 4,
that is 4096 x w^2 cells x 4 channels x 2 (read and write): 103 MB at
complex128 and w = 14 (31 us at 3.35 TB/s), 16.8 MB at complex64 and
w = 8 (5.0 us). The summation order of the atomics varies from run to run:
results agree with the plain version to rounding, never bit for bit.

The tap math is exactly that of the JAX scatter spreader
(``_spread_scatter``): ``i0 = ceil(u - w/2)``, kernel argument
``t = (cell - (i0 + k)) + frac`` from the cell/frac split, every tap taken
``mod nf``. A coordinate that rounded to exactly ``nf`` wraps through the
modulus.

The spread is linear in the weights, and its adjoint with respect to them
is a gather: :func:`spread_adjoint` reads each source's w x w taps of a
(C, nfy, nfx) grid gradient, giving (C, n) -- the CUDA kernel
``spread_adjoint_gm`` (one warp a source, the 2w ES values evaluated once,
no atomics) or :func:`spread_adjoint_plain` on the CPU.
:class:`SpreadFunction` binds the two for autograd; :func:`spread` takes it
when the weights or the grid require a gradient, and accumulates in place
either way. The coordinates are planning inputs and get no gradient.
``launches`` and ``adjoint_launches`` count the two kernels' launches.

:func:`spread_nd` spreads onto a grid of any dimension d = 1, 2, 3 (the
public type-1 and type-3 transforms): d = 2 is :func:`spread`, and d = 1
and d = 3 launch ``spread_gm_1d`` and ``spread_gm_3d`` (the same GM
method: one warp a source, its ES values once, atomics; at d = 3 the lanes
cover the taps of the last two axes and a loop the first), counted by
``launches_d1`` and ``launches_d3``, with :func:`spread_nd_plain` (the JAX
``_spread_scatter`` of any d) on the CPU. Gradients at d = 1 and 3 are not
ported.
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import es_kernel_grid

launches = 0
adjoint_launches = 0
launches_d1 = 0
launches_d3 = 0


def spread_taps_nd(u, nf, w: int, beta: float):
    """The w^d taps of every source on the periodic grid ``nf``: flat cell
    indices (n * w^d,) into the row-major grid, taken mod nf, and ES kernel
    values (n, w^d); ``u`` the d per-axis (n,) grid coordinates."""
    n = u[0].shape[0]
    offs = torch.arange(w, device=u[0].device)
    flat = vals = None
    for ua, nfa in zip(u, nf):
        cell = torch.floor(ua)
        frac = ua - cell
        i0 = torch.ceil(ua - w / 2.0).to(torch.int64)
        ii = i0[:, None] + offs[None, :]  # (n, w) signed
        t = (cell[:, None] - ii.to(cell.dtype)) + frac[:, None]
        v = es_kernel_grid(t, w, beta)
        idx = torch.remainder(ii, int(nfa))
        if flat is None:
            flat, vals = idx, v
        else:
            flat = (flat[:, :, None] * int(nfa) + idx[:, None, :]).reshape(n, -1)
            vals = (vals[:, :, None] * v[:, None, :]).reshape(n, -1)
    return flat.reshape(-1), vals


def spread_taps(uy, ux, nfy: int, nfx: int, w: int, beta: float):
    """The w x w taps of every source: flat cell indices (n * w^2,) into the
    (nfy * nfx) grid, taken mod nf, and ES kernel values (n, w^2)."""
    return spread_taps_nd((uy, ux), (nfy, nfx), w, beta)


def spread_nd_plain(u, wts, grid, w: int, beta: float) -> torch.Tensor:
    """Plain torch spreader of any dimension: ``index_add_`` on the
    flattened (C, prod(nf)) grid, the JAX package's ``_spread_scatter``.
    Accumulates into ``grid`` (C, *nf) in place and returns it."""
    C = grid.shape[0]
    flat_idx, vals = spread_taps_nd(u, grid.shape[1:], w, beta)
    contrib = wts[:, :, None] * vals[None, :, :]  # (C, n, w^d)
    # Scatter the re/im planes as reals: index_add_ of reals is supported
    # on every device.
    torch.view_as_real(grid).view(C, -1, 2).index_add_(
        1, flat_idx, torch.view_as_real(contrib).reshape(C, -1, 2)
    )
    return grid


def spread_plain(uy, ux, wts, grid, w: int, beta: float) -> torch.Tensor:
    """Plain torch 2D spreader (:func:`spread_nd_plain` at d = 2).
    Accumulates into ``grid`` in place and returns it."""
    return spread_nd_plain((uy, ux), wts, grid, w, beta)


def spread_adjoint_plain(uy, ux, grid, w: int, beta: float) -> torch.Tensor:
    """Plain torch adjoint of :func:`spread_plain` with respect to the
    weights: each source's w x w taps of ``grid`` (C, nfy, nfx) times their
    (real) ES values, summed. Returns (C, n) complex."""
    C, nfy, nfx = grid.shape
    n = uy.shape[0]
    flat_idx, vals = spread_taps(uy, ux, nfy, nfx, w, beta)
    taps = grid.reshape(C, nfy * nfx)[:, flat_idx].reshape(C, n, w * w)
    return (taps * vals[None, :, :]).sum(dim=2)


def _check(uy, ux, wts, grid, w: int) -> None:
    if not (uy.device == ux.device == wts.device == grid.device):
        raise ValueError("spread: all tensors must be on one device")
    rdt = uy.dtype
    if rdt not in (torch.float32, torch.float64):
        raise TypeError(f"spread: coordinates must be float32/float64, got {rdt}")
    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
    if ux.dtype != rdt or wts.dtype != cdt or grid.dtype != cdt:
        raise TypeError(
            f"spread: expected {rdt} coordinates and {cdt} weights/grid, got "
            f"{ux.dtype}, {wts.dtype}, {grid.dtype}"
        )
    if uy.dim() != 1 or ux.shape != uy.shape:
        raise ValueError("spread: uy and ux must be matching (n,) vectors")
    if wts.dim() != 2 or wts.shape[1] != uy.shape[0]:
        raise ValueError(f"spread: weights must be (C, n), got {tuple(wts.shape)}")
    if grid.dim() != 3 or grid.shape[0] != wts.shape[0]:
        raise ValueError(f"spread: grid must be (C, nfy, nfx), got {tuple(grid.shape)}")
    if not grid.is_contiguous():
        raise ValueError("spread: grid must be contiguous")
    if not 2 <= w <= 16:
        raise ValueError(f"spread: kernel width {w} outside [2, 16]")


def spread(uy, ux, wts, grid, w: int, beta: float) -> torch.Tensor:
    """Spread (C, n) complex weights at grid coordinates (uy, ux) in
    [0, nf] onto ``grid`` (C, nfy, nfx), in place.

    A CPU tensor takes :func:`spread_plain`; a CUDA tensor launches the
    CUDA kernel; any other device raises. Where the weights or the grid
    require a gradient, the call goes through :class:`SpreadFunction`.
    """
    _check(uy, ux, wts, grid, w)
    if torch.is_grad_enabled() and (wts.requires_grad or grid.requires_grad):
        return SpreadFunction.apply(uy, ux, wts, grid, w, beta)
    return _spread(uy, ux, wts, grid, w, beta)


def _spread(uy, ux, wts, grid, w: int, beta: float) -> torch.Tensor:
    if grid.device.type == "cpu":
        return spread_plain(uy, ux, wts, grid, w, beta)
    if grid.device.type != "cuda":
        raise ValueError(f"spread: unsupported device {grid.device}")
    return _spread_cuda(uy, ux, wts, grid, w, beta)


def _spread_cuda(uy, ux, wts, grid, w: int, beta: float) -> torch.Tensor:
    global launches
    from .._build import load_kernels

    lib = load_kernels()
    C, nfy, nfx = grid.shape
    n = uy.shape[0]
    if n == 0:
        return grid
    uy, ux, wts = uy.contiguous(), ux.contiguous(), wts.contiguous()
    fn = lib.fftvis_spread_f32 if uy.dtype == torch.float32 else lib.fftvis_spread_f64
    err = fn(
        ctypes.c_void_p(uy.data_ptr()),
        ctypes.c_void_p(ux.data_ptr()),
        ctypes.c_void_p(wts.data_ptr()),
        ctypes.c_void_p(grid.data_ptr()),
        n, C, nfy, nfx, w, float(beta),
        ctypes.c_void_p(torch.cuda.current_stream(grid.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"spread kernel launch failed: CUDA error {err}")
    launches += 1
    return grid


def spread_adjoint(uy, ux, grid, w: int, beta: float) -> torch.Tensor:
    """The adjoint of :func:`spread` with respect to the weights: the (C, n)
    complex gather of each source's taps of the (C, nfy, nfx) ``grid``.

    A CPU tensor takes :func:`spread_adjoint_plain`; a CUDA tensor launches
    ``spread_adjoint_gm``; any other device raises.
    """
    C, n = grid.shape[0], uy.shape[0]
    grid = grid.contiguous()
    _check(uy, ux, grid.new_empty((C, n)), grid, w)
    if grid.device.type == "cpu":
        return spread_adjoint_plain(uy, ux, grid, w, beta)
    if grid.device.type != "cuda":
        raise ValueError(f"spread_adjoint: unsupported device {grid.device}")
    return _spread_adjoint_cuda(uy.contiguous(), ux.contiguous(), grid, w, beta)


def _spread_adjoint_cuda(uy, ux, grid, w: int, beta: float) -> torch.Tensor:
    global adjoint_launches
    from .._build import load_kernels

    lib = load_kernels()
    C, nfy, nfx = grid.shape
    n = uy.shape[0]
    out = torch.empty((C, n), dtype=grid.dtype, device=grid.device)
    if n == 0 or C == 0:
        return out.zero_()
    fn = (lib.fftvis_spread_adjoint_f32 if uy.dtype == torch.float32
          else lib.fftvis_spread_adjoint_f64)
    err = fn(
        ctypes.c_void_p(uy.data_ptr()),
        ctypes.c_void_p(ux.data_ptr()),
        ctypes.c_void_p(grid.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        n, C, nfy, nfx, w, float(beta),
        ctypes.c_void_p(torch.cuda.current_stream(grid.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"spread_adjoint kernel launch failed: CUDA error {err}")
    adjoint_launches += 1
    return out


class SpreadFunction(torch.autograd.Function):
    """:func:`spread` for autograd: ``apply(uy, ux, wts, grid, w, beta)``
    adds the spread of ``wts`` to ``grid`` in place and returns it. The
    gradient of the weights is :func:`spread_adjoint` of the grid's
    gradient, the grid's passes through; the coordinates get none."""

    @staticmethod
    def forward(ctx, uy, ux, wts, grid, w, beta):
        _spread(uy, ux, wts, grid, w, beta)
        ctx.mark_dirty(grid)
        ctx.save_for_backward(uy, ux)
        ctx.w, ctx.beta = w, beta
        return grid

    @staticmethod
    def backward(ctx, g):
        uy, ux = ctx.saved_tensors
        gw = spread_adjoint(uy, ux, g, ctx.w, ctx.beta) if ctx.needs_input_grad[2] else None
        return None, None, gw, g if ctx.needs_input_grad[3] else None, None, None


def _check_nd(u, wts, grid, w: int) -> None:
    d = len(u)
    if d not in (1, 2, 3):
        raise ValueError(f"spread: d={d} outside 1..3")
    if grid.dim() != 1 + d:
        raise ValueError(f"spread: a d={d} grid must be (C, *nf), got {tuple(grid.shape)}")
    ux = u[1] if d > 1 else u[0]
    # The 2D checks, run on the first and last axes' coordinates and a
    # (C, n0, n_last) view of the grid's shape.
    _check(u[0], ux, wts, grid.new_empty((grid.shape[0], 0, 0)), w)
    if any(ua.shape != u[0].shape or ua.dtype != u[0].dtype or ua.device != u[0].device
           for ua in u):
        raise ValueError("spread: coordinates must be matching (n,) vectors on one device")
    if grid.device != wts.device or not grid.is_contiguous():
        raise ValueError("spread: grid must be contiguous on the weights' device")


def spread_nd(u, wts, grid, w: int, beta: float) -> torch.Tensor:
    """Spread (C, n) complex weights at the d per-axis grid coordinates
    ``u`` (each (n,), in [0, nf]) onto ``grid`` (C, *nf), d = 1, 2, 3, in
    place.

    d = 2 is :func:`spread`. At d = 1 and 3 a CPU tensor takes
    :func:`spread_nd_plain`, a CUDA tensor launches ``spread_gm_1d`` /
    ``spread_gm_3d``, any other device raises; a weight or grid that
    requires a gradient raises ``NotImplementedError``.
    """
    u = tuple(u)
    if len(u) == 2:
        return spread(u[0], u[1], wts, grid, w, beta)
    _check_nd(u, wts, grid, w)
    if torch.is_grad_enabled() and (wts.requires_grad or grid.requires_grad):
        raise NotImplementedError(
            f"gradients through the d={len(u)} spread are ROADMAP item 13")
    if grid.device.type == "cpu":
        return spread_nd_plain(u, wts, grid, w, beta)
    if grid.device.type != "cuda":
        raise ValueError(f"spread: unsupported device {grid.device}")
    return _spread_nd_cuda(u, wts, grid, w, beta)


def _spread_nd_cuda(u, wts, grid, w: int, beta: float) -> torch.Tensor:
    global launches_d1, launches_d3
    from .._build import load_kernels

    lib = load_kernels()
    d, n = len(u), u[0].shape[0]
    if n == 0:
        return grid
    C, nf = grid.shape[0], tuple(grid.shape[1:]) + (1,) * (3 - len(u))
    u = [ua.contiguous() for ua in u]
    wts = wts.contiguous()
    ptr = [ctypes.c_void_p(ua.data_ptr()) for ua in u] + [ctypes.c_void_p(None)] * (3 - d)
    fn = lib.fftvis_spread_nd_f32 if u[0].dtype == torch.float32 else lib.fftvis_spread_nd_f64
    err = fn(
        d, *ptr,
        ctypes.c_void_p(wts.data_ptr()),
        ctypes.c_void_p(grid.data_ptr()),
        n, C, *nf, w, float(beta),
        ctypes.c_void_p(torch.cuda.current_stream(grid.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"spread (d={d}) kernel launch failed: CUDA error {err}")
    if d == 1:
        launches_d1 += 1
    else:
        launches_d3 += 1
    return grid
