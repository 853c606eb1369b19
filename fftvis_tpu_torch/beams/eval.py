"""Beam-table evaluation: the hand-written CUDA kernel and its plain torch
version.

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

The TPU kernel bin-sorts points into tiles and rebuilds the taps as one-hot
matrices for its matrix unit, because gathers are slow there. On the card a
direct gather is the natural form: the CUDA kernel (``csrc/beam_eval.cu``)
runs one thread per (point, channel), channel fastest, so a warp's tap
reads are contiguous ch-vectors; outputs are disjoint, so there are no
atomics, no sort and no pads.

Cells come from an exact floor of the raw coordinate, folded (wrap) or
mirrored in integer arithmetic; ``y >= ny-1`` reads row ``ny-1`` at order
1, as the TPU kernel and scipy do. (The JAX gather path's float64 order-1
clip sends ``y >= ny-1`` to row ``ny-2``; the port does not copy that.)

What bounds it on the card: npts * taps * ch gathered reals from a table
that fits in L2; at the slice's 4096-point source blocks a call is
launch-bound.
"""

from __future__ import annotations

import ctypes

import torch

launches = 0


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


def _check(data, y, x, order: int) -> None:
    if not (data.device == y.device == x.device):
        raise ValueError("beam_eval: all tensors must be on one device")
    if data.dtype not in (torch.float32, torch.float64):
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
    if data.device.type == "cpu":
        return beam_eval_plain(data, y, x, order, wrap_x)
    if data.device.type != "cuda":
        raise ValueError(f"beam_eval: unsupported device {data.device}")
    return _beam_eval_cuda(data, y.contiguous(), x.contiguous(), order, wrap_x)


def _beam_eval_cuda(data, y, x, order: int, wrap_x: bool) -> torch.Tensor:
    global launches
    from .._build import load_kernels

    lib = load_kernels()
    ny, nx, ch = data.shape
    npts = y.shape[0]
    out = torch.empty((npts, ch), dtype=data.dtype, device=data.device)
    if npts == 0 or ch == 0:
        return out
    fn = lib.fftvis_beam_eval_f32 if data.dtype == torch.float32 else lib.fftvis_beam_eval_f64
    err = fn(
        ctypes.c_void_p(data.data_ptr()),
        ctypes.c_void_p(y.data_ptr()),
        ctypes.c_void_p(x.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        npts, ny, nx, ch, order, int(bool(wrap_x)),
        ctypes.c_void_p(torch.cuda.current_stream(data.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"beam_eval kernel launch failed: CUDA error {err}")
    launches += 1
    return out
