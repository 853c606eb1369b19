"""2D ES spreading: the hand-written CUDA kernel and its plain torch version.

Replaces the Pallas band-accumulator spreader of the JAX package
(``fftvis_tpu/nufft/pallas_spread.py``, ``_build_pallas_call``, driven by
``spread_pallas_tiled``), which computes

    g[c, y, x] += sum_j psi(y - uy_j) psi(x - ux_j) w[c, j]

on the periodic (C, nfy, nfx) fine grid. The CUDA kernel
(``csrc/spread.cu``) is cuFINUFFT's shared-memory method (arXiv 2102.08463):

- a torch pre-pass bins the sources into TILE x TILE cell tiles (tile id
  from the integer cell ``floor(u) // TILE``, clamped to the last tile, a
  stable sort, CSR offsets by ``searchsorted`` of the sorted ids);
- one block per tile accumulates the tile's (TILE + w + 1)^2 window, for a
  group of channels at a time, in shared memory with shared atomics;
- the block then adds the window's nonzero cells into the global grid at
  ``(y mod nfy, x mod nfx)`` with global atomics. That replaces the TPU
  kernel's band overlap-add and periodic fold; unlike the TPU grid, CUDA
  blocks run concurrently and their halos overlap, so the flush must be
  atomic.

What bounds it on the card: n * w^2 * 2C shared-memory atomics plus the
window flush (at most one global atomic per touched window cell and
plane). Skipping zero cells in the flush keeps a sparsely occupied tile
from paying a whole window of global atomics. The summation order of the
float atomics varies from run to run: results agree with the plain version
to rounding, never bit for bit.

The tap math is exactly that of the JAX scatter spreader
(``_spread_scatter``): ``i0 = ceil(u - w/2)``, kernel argument
``t = (cell - (i0 + k)) + frac`` from the cell/frac split, every tap taken
``mod nf``. A coordinate that rounded to exactly ``nf`` lands in the last
tile and wraps through the modulus.
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import es_kernel_grid

TILE = 32
# Shared-memory budget of one block's window (the default 48 KB a block
# can use without opting in to more).
SMEM_BUDGET = 48 * 1024

launches = 0


def spread_plain(uy, ux, wts, grid, w: int, beta: float) -> torch.Tensor:
    """Plain torch spreader: ``index_add_`` on the flattened (C, nfy*nfx)
    grid, the 2D form of the JAX package's ``_spread_scatter``.
    Accumulates into ``grid`` in place and returns it."""
    C, nfy, nfx = grid.shape
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
    contrib = wts[:, :, None] * vals[None, :, :]  # (C, n, w^2)
    # Scatter the re/im planes as reals: index_add_ of reals is supported
    # on every device.
    torch.view_as_real(grid).view(C, nfy * nfx, 2).index_add_(
        1, flat_idx, torch.view_as_real(contrib).reshape(C, -1, 2)
    )
    return grid


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
    CUDA kernel; any other device raises.
    """
    _check(uy, ux, wts, grid, w)
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
    nty, ntx = -(-nfy // TILE), -(-nfx // TILE)
    # Bin pre-pass: integer-cell tile ids (exact), clamped to the last tile
    # (u may have rounded to exactly nf), then a stable sort.
    tiy = torch.clamp(torch.floor(uy).to(torch.int64) // TILE, 0, nty - 1)
    tix = torch.clamp(torch.floor(ux).to(torch.int64) // TILE, 0, ntx - 1)
    tid_sorted, order = torch.sort(tiy * ntx + tix, stable=True)
    # CSR offsets by binary search of the sorted ids (bincount would read
    # the maximum id back to the host and stall the stream).
    bounds = torch.arange(nty * ntx + 1, device=uy.device)
    starts = torch.searchsorted(tid_sorted, bounds, out_int32=True)
    order = order.to(torch.int32)

    real_bytes = uy.element_size()
    win = TILE + w + 1
    group = max(1, min(C, SMEM_BUDGET // (2 * win * win * real_bytes)))
    fn = lib.fftvis_spread_f32 if uy.dtype == torch.float32 else lib.fftvis_spread_f64
    err = fn(
        ctypes.c_void_p(uy.data_ptr()),
        ctypes.c_void_p(ux.data_ptr()),
        ctypes.c_void_p(wts.data_ptr()),
        ctypes.c_void_p(order.data_ptr()),
        ctypes.c_void_p(starts.data_ptr()),
        ctypes.c_void_p(grid.data_ptr()),
        n, C, nfy, nfx, TILE, nty, ntx, w, float(beta), group,
        ctypes.c_void_p(torch.cuda.current_stream(grid.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"spread kernel launch failed: CUDA error {err}")
    launches += 1
    return grid
