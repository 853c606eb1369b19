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
no atomics, bitwise repeatable) or :func:`spread_adjoint_plain` on the CPU.
:class:`SpreadFunction` binds the two for autograd; :func:`spread` takes it
when the weights or the grid require a gradient, and accumulates in place
either way. The coordinates are planning inputs and get no gradient.
``launches`` and ``adjoint_launches`` count the two kernels' launches.

:func:`spread_nd` spreads onto a grid of any dimension d = 1, 2, 3 (the
public type-1 and type-3 transforms): d = 2 is :func:`spread`, and d = 1
launches ``spread_gm_1d`` (the GM method: a block of 128 sources, their ES
values once into shared memory, then every lane an item (source, tap[,
re/im]) with an atomic), counted by ``launches_d1``. At d = 3 the library
picks the form by size and shape (``fftvis_spread_nd_bin_edge``): on a dense grid
``spread_sm_3d``, after cuFINUFFT's SM method -- a counting sort on the
card orders the sources by the 3D bin of their first tap cell
(:func:`device_bin_sort_3d`; :func:`bin_sort_3d` is its plain version),
one block accumulates up to SUBPROBLEM sources of a bin into the bin's
padded tile, held in registers, and adds it to the grid once -- counted by
``launches_d3_sm``; with too few sources in all or a bin (the library's
``kSmMinSources``, ``kSmMinSourcesPerBin``, measured on the card), or on a
grid with an axis shorter than the padded tile, ``spread_gm_3d`` (the GM
method, the lanes over the taps of the last two axes and a loop over the
first), counted by ``launches_d3``. :func:`spread_nd_plain` (the JAX
``_spread_scatter`` of any d) runs on the CPU. Gradients at d = 1 and 3 are
not ported.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .kernels import es_kernel_grid

launches = 0
adjoint_launches = 0
launches_d1 = 0
launches_d3 = 0
launches_d3_sm = 0
sort_launches = 0
# Sources a subproblem (a block) of spread_sm_3d at most: a crowded bin
# spreads over several blocks, each flushing its own tile.
SUBPROBLEM = 256


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


def bin_keys_3d(u, nf, w: int, edge: int) -> torch.Tensor:
    """Every source's bin: the bin (``edge`` cells a side, row-major over the
    bins) of its first tap cell ``ceil(u - w/2) mod nf``, int64."""
    key = None
    for ua, n in zip(u, nf):
        b = torch.remainder(torch.ceil(ua - w / 2.0).long(), int(n)) // edge
        key = b if key is None else key * -(-int(n) // edge) + b
    return key


def bin_sort_3d(u, nf, w: int, edge: int):
    """The plain version of ``spread_sm_3d``'s device bin sort: the sources
    ordered stably by :func:`bin_keys_3d`, on the coordinates' device.
    Returns (perm, offsets), int64: ``perm[k]`` the k-th source in bin
    order, and the CSR offsets (nbins + 1,) of every bin, empty or not."""
    nbins = int(np.prod([-(-int(n) // edge) for n in nf]))
    keys, perm = torch.sort(bin_keys_3d(u, nf, w, edge), stable=True)
    return perm, torch.searchsorted(keys, torch.arange(nbins + 1, device=keys.device))


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


def _check_coords_grid(uy, ux, grid, w: int, what: str) -> None:
    """The checks :func:`spread` and :func:`spread_adjoint` share: the
    coordinates' and the grid's device, dtypes and shapes, and w."""
    if not (uy.device == ux.device == grid.device):
        raise ValueError(f"{what}: all tensors must be on one device")
    rdt = uy.dtype
    if rdt not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: coordinates must be float32/float64, got {rdt}")
    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
    if ux.dtype != rdt or grid.dtype != cdt:
        raise TypeError(f"{what}: expected {rdt} coordinates and a {cdt} grid, got "
                        f"{ux.dtype}, {grid.dtype}")
    if uy.dim() != 1 or ux.shape != uy.shape:
        raise ValueError(f"{what}: uy and ux must be matching (n,) vectors")
    if grid.dim() != 3:
        raise ValueError(f"{what}: grid must be (C, nfy, nfx), got {tuple(grid.shape)}")
    if not 2 <= w <= 16:
        raise ValueError(f"{what}: kernel width {w} outside [2, 16]")


def _check(uy, ux, wts, grid, w: int) -> None:
    _check_coords_grid(uy, ux, grid, w, "spread")
    if wts.device != grid.device:
        raise ValueError("spread: all tensors must be on one device")
    if wts.dtype != grid.dtype:
        raise TypeError(f"spread: expected {grid.dtype} weights, got {wts.dtype}")
    if wts.dim() != 2 or wts.shape[1] != uy.shape[0]:
        raise ValueError(f"spread: weights must be (C, n), got {tuple(wts.shape)}")
    if grid.shape[0] != wts.shape[0]:
        raise ValueError(f"spread: grid must be (C, nfy, nfx), got {tuple(grid.shape)}")
    if not grid.is_contiguous():
        raise ValueError("spread: grid must be contiguous")


def spread(uy, ux, wts, grid, w: int, beta: float) -> torch.Tensor:
    """Spread (C, n) complex weights at grid coordinates (uy, ux) onto
    ``grid`` (C, nfy, nfx), in place; every tap is taken mod nf, so the
    coordinates may be any reals (the executors pass them in [-nf/2,
    nf]).

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
    _check_coords_grid(uy, ux, grid, w, "spread_adjoint")
    grid = grid.contiguous()
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
        n, C, nfy, nfx, w, float(beta), _stream(grid),
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
    u0 = u[0]
    dev, rdt, shape = u0.device, u0.dtype, u0.shape
    if wts.device != dev or grid.device != dev:
        raise ValueError("spread: all tensors must be on one device")
    if rdt not in (torch.float32, torch.float64):
        raise TypeError(f"spread: coordinates must be float32/float64, got {rdt}")
    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
    for ua in u:
        if ua.dtype != rdt or wts.dtype != cdt or grid.dtype != cdt:
            raise TypeError(f"spread: expected {rdt} coordinates and {cdt} weights/grid, got "
                            f"{ua.dtype}, {wts.dtype}, {grid.dtype}")
        if ua.shape != shape or ua.device != dev:
            raise ValueError("spread: coordinates must be matching (n,) vectors on one device")
    if u0.dim() != 1:
        raise ValueError("spread: coordinates must be matching (n,) vectors on one device")
    if wts.dim() != 2 or wts.shape[1] != shape[0]:
        raise ValueError(f"spread: weights must be (C, n), got {tuple(wts.shape)}")
    if grid.shape[0] != wts.shape[0]:
        raise ValueError(f"spread: grid must be (C, *nf), got {tuple(grid.shape)}")
    if not grid.is_contiguous():
        raise ValueError("spread: grid must be contiguous")
    if not 2 <= w <= 16:
        raise ValueError(f"spread: kernel width {w} outside [2, 16]")


def spread_nd(u, wts, grid, w: int, beta: float) -> torch.Tensor:
    """Spread (C, n) complex weights at the d per-axis grid coordinates
    ``u`` (each (n,), any reals: taps are taken mod nf) onto ``grid`` (C,
    *nf), d = 1, 2, 3, in place.

    d = 2 is :func:`spread`. At d = 1 and 3 a CPU tensor takes
    :func:`spread_nd_plain`; a CUDA tensor launches ``spread_gm_1d``, or at
    d = 3 ``spread_sm_3d`` or ``spread_gm_3d`` as the library's
    ``fftvis_spread_nd_bin_edge`` picks by size and shape; any other device raises; a
    weight or grid that requires a gradient raises ``NotImplementedError``.
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
    if u[0].shape[0] == 0:
        return grid
    if len(u) == 3:
        from .._build import load_kernels

        edge = load_kernels().fftvis_spread_nd_bin_edge(
            int(u[0].dtype == torch.float64), w, u[0].shape[0], *grid.shape[1:])
        if edge:
            return _spread_sm_3d(u, wts, grid, w, beta, edge)
    return _spread_gm_nd(u, wts, grid, w, beta)


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _spread_gm_nd(u, wts, grid, w: int, beta: float) -> torch.Tensor:
    """``spread_gm_1d`` / ``spread_gm_3d`` on CUDA tensors that passed
    :func:`_check_nd`."""
    global launches_d1, launches_d3
    from .._build import load_kernels

    lib = load_kernels()
    d, n = len(u), u[0].shape[0]
    C, nf = grid.shape[0], tuple(grid.shape[1:]) + (1,) * (3 - len(u))
    u = [ua.contiguous() for ua in u]
    wts = wts.contiguous()
    ptr = [ctypes.c_void_p(ua.data_ptr()) for ua in u] + [ctypes.c_void_p(None)] * (3 - d)
    fn = lib.fftvis_spread_nd_f32 if u[0].dtype == torch.float32 else lib.fftvis_spread_nd_f64
    err = fn(d, *ptr, ctypes.c_void_p(wts.data_ptr()), ctypes.c_void_p(grid.data_ptr()),
             n, C, *nf, w, float(beta), _stream(grid))
    if err != 0:
        raise RuntimeError(f"spread (d={d}) kernel launch failed: CUDA error {err}")
    if d == 1:
        launches_d1 += 1
    else:
        launches_d3 += 1
    return grid


def device_bin_sort_3d(u, nf, w: int, edge: int):
    """:func:`bin_sort_3d` on CUDA coordinates by the library's counting sort
    (``bin_count``, ``bin_scan``, ``bin_scatter``), which also gives each
    bin's first subproblem of SUBPROBLEM sources: (perm, offsets, sub),
    int64. Within a bin the order follows the sort's atomics. Counted by
    ``sort_launches``. Raises ``ValueError`` on an edge below 1 and on
    coordinates that are not CUDA tensors, before the library loads."""
    global sort_launches
    from .._build import load_kernels

    if int(edge) < 1:
        raise ValueError(f"device_bin_sort_3d: bin edge {edge} < 1")
    if len(u) != 3 or any(t.device.type != "cuda" for t in u):
        raise ValueError("device_bin_sort_3d: the 3 coordinate vectors must be CUDA tensors, "
                         f"got {[str(t.device) for t in u]}")
    n = u[0].shape[0]
    nbins = int(np.prod([-(-int(m) // edge) for m in nf]))
    dev = u[0].device
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    off, sub = torch.empty((2, nbins + 1), dtype=torch.int64, device=dev)
    scratch = torch.empty(n + nbins, dtype=torch.int32, device=dev)
    lib = load_kernels()
    fn = lib.fftvis_bin_sort_3d_f32 if u[0].dtype == torch.float32 else lib.fftvis_bin_sort_3d_f64
    err = fn(*[ctypes.c_void_p(t.data_ptr()) for t in u], n, *(int(m) for m in nf), w, edge,
             SUBPROBLEM, *[ctypes.c_void_p(t.data_ptr()) for t in (scratch, perm, off, sub)],
             _stream(u[0]))
    if err != 0:
        raise RuntimeError(f"bin sort kernel launch failed: CUDA error {err}")
    sort_launches += 1
    return perm, off, sub


def _spread_sm_3d(u, wts, grid, w: int, beta: float, edge: int) -> torch.Tensor:
    """``spread_sm_3d`` on CUDA tensors that passed :func:`_check_nd`, after
    the device bin sort at bin edge ``edge`` (the library's for this w and
    dtype), which counts in its time."""
    global launches_d3_sm
    from .._build import load_kernels

    lib = load_kernels()
    n, C = u[0].shape[0], grid.shape[0]
    u = [ua.contiguous() for ua in u]
    wts = wts.contiguous()
    perm, offsets, sub = device_bin_sort_3d(u, grid.shape[1:], w, edge)
    # Blocks enough for every subproblem (the surplus exits at once).
    nsub = offsets.shape[0] - 1 + -(-n // SUBPROBLEM)
    fn = (lib.fftvis_spread_sm_3d_f32 if u[0].dtype == torch.float32
          else lib.fftvis_spread_sm_3d_f64)
    err = fn(*[ctypes.c_void_p(t.data_ptr()) for t in (*u, wts, perm, offsets, sub, grid)],
             n, C, *grid.shape[1:], nsub, SUBPROBLEM, w, float(beta), _stream(grid))
    if err != 0:
        raise RuntimeError(f"spread (d=3, SM) kernel launch failed: CUDA error {err}")
    launches_d3_sm += 1
    return grid
