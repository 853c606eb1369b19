"""2D ES spreading: the hand-written CUDA kernel and its plain torch version.

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
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import es_kernel_grid

launches = 0
adjoint_launches = 0


def spread_taps(uy, ux, nfy: int, nfx: int, w: int, beta: float):
    """The w x w taps of every source: flat cell indices (n * w^2,) into the
    (nfy * nfx) grid, taken mod nf, and ES kernel values (n, w^2)."""
    n = uy.shape[0]
    offs = torch.arange(w, device=uy.device)
    idx_dim, val_dim = [], []
    for u, nf in ((uy, nfy), (ux, nfx)):
        cell = torch.floor(u)
        frac = u - cell
        i0 = torch.ceil(u - w / 2.0).to(torch.int64)
        ii = i0[:, None] + offs[None, :]  # (n, w) signed
        t = (cell[:, None] - ii.to(cell.dtype)) + frac[:, None]
        val_dim.append(es_kernel_grid(t, w, beta))
        idx_dim.append(torch.remainder(ii, nf))
    flat_idx = (idx_dim[0][:, :, None] * nfx + idx_dim[1][:, None, :]).reshape(-1)
    vals = (val_dim[0][:, :, None] * val_dim[1][:, None, :]).reshape(n, w * w)
    return flat_idx, vals


def spread_plain(uy, ux, wts, grid, w: int, beta: float) -> torch.Tensor:
    """Plain torch spreader: ``index_add_`` on the flattened (C, nfy*nfx)
    grid, the 2D form of the JAX package's ``_spread_scatter``.
    Accumulates into ``grid`` in place and returns it."""
    C, nfy, nfx = grid.shape
    flat_idx, vals = spread_taps(uy, ux, nfy, nfx, w, beta)
    contrib = wts[:, :, None] * vals[None, :, :]  # (C, n, w^2)
    # Scatter the re/im planes as reals: index_add_ of reals is supported
    # on every device.
    torch.view_as_real(grid).view(C, nfy * nfx, 2).index_add_(
        1, flat_idx, torch.view_as_real(contrib).reshape(C, -1, 2)
    )
    return grid


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
