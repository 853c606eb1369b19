"""Regular-grid beam interpolation: the cubic-spline prefilter and a
channels-first ``map_coordinates``.

The port of ``fftvis_tpu/beams/interp.py``:

- :func:`spline_prefilter_2d` turns a table into cubic B-spline
  coefficients, once, at prepare time, in float64 NumPy: scipy's 'mirror'
  recursion along za, and along a full-circle azimuth the periodic
  (circulant) solve, so that periodic taps reconstruct the table at the
  seam;
- :func:`map_coordinates_2d` interpolates a ``(..., ny, nx)`` tensor at
  fractional coordinates through the channels-last evaluator
  (:func:`fftvis_tpu_torch.beams.eval.beam_eval`, which holds the CUDA
  kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from .eval import beam_eval

_POLE = np.sqrt(3.0) - 2.0  # cubic B-spline filter pole


def _prefilter_axis(data: np.ndarray, axis: int) -> np.ndarray:
    """Cubic-B-spline prefilter along ``axis`` (scipy 'mirror' boundary)."""
    z = _POLE
    x = np.moveaxis(data, axis, 0)
    n = x.shape[0]
    if n == 1:
        return data
    x = x * ((1.0 - z) * (1.0 - 1.0 / z))

    # Exact causal init for the 'mirror' boundary (Unser's formula): the
    # mirrored extension has period 2n-2, so
    #   c0 = sum_k coeff[k] x[k] / (1 - z^(2n-2)),
    # with coeff[0] = 1, coeff[n-1] = z^(n-1), else z^k + z^(2n-2-k).
    k = np.arange(n)
    coeff = z**k + z ** (2 * n - 2 - k)
    coeff[0] = 1.0
    coeff[n - 1] = z ** (n - 1)
    coeff /= 1.0 - z ** (2 * n - 2)
    y = np.empty_like(x)
    y[0] = np.tensordot(coeff, x, axes=(0, 0))
    for i in range(1, n):  # causal pass
        y[i] = x[i] + z * y[i - 1]
    c = np.empty_like(y)
    c[n - 1] = (z / (z * z - 1.0)) * (y[n - 1] + z * y[n - 2])
    for i in range(n - 2, -1, -1):  # anticausal pass
        c[i] = z * (c[i + 1] - y[i])
    return np.moveaxis(c, 0, axis)


def _prefilter_axis_periodic(data: np.ndarray, axis: int) -> np.ndarray:
    """Cubic-B-spline prefilter along a periodic ``axis``: solves the
    circulant system (c[i-1] + 4 c[i] + c[i+1]) / 6 = x[i] in the Fourier
    domain (eigenvalues (4 + 2 cos(2 pi k / n)) / 6)."""
    x = np.moveaxis(data, axis, -1)
    n = x.shape[-1]
    if n == 1:
        return data
    eig = (4.0 + 2.0 * np.cos(2.0 * np.pi * np.arange(n) / n)) / 6.0
    c = np.fft.ifft(np.fft.fft(x, axis=-1) / eig, axis=-1)
    if not np.iscomplexobj(data):
        c = c.real
    return np.moveaxis(c, -1, axis)


def spline_prefilter_2d(data, axes=(-2, -1), periodic_x: bool = False) -> np.ndarray:
    """Cubic-B-spline prefilter along two axes, in float64 (complex128 for
    complex data).

    ``periodic_x`` selects the periodic boundary for the last axis of
    ``axes`` (a full-circle azimuth evaluated with ``wrap_x=True``); the
    other axis always uses scipy's 'mirror' boundary.
    """
    data = np.asarray(data)
    data = data.astype(np.result_type(data.dtype, np.float64), copy=False)
    out = _prefilter_axis(data, axes[0])
    if periodic_x:
        return np.ascontiguousarray(_prefilter_axis_periodic(out, axes[1]))
    return np.ascontiguousarray(_prefilter_axis(out, axes[1]))


def map_coordinates_2d(data: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                       order: int = 1, wrap_x: bool = False,
                       prefiltered: bool = False) -> torch.Tensor:
    """Interpolate ``data[..., ny, nx]`` (real or complex) at (npts,)
    fractional coordinates (y, x); returns ``(..., npts)``.

    Order 1 is bilinear, order 3 the cubic B-spline (its coefficients are
    computed here unless ``prefiltered``). y clamps (order 1) or mirrors
    (order 3); x does the same unless ``wrap_x``, which indexes it
    periodically. Edge rows follow the TPU kernel and scipy: ``y >= ny-1``
    reads row ``ny-1``.
    """
    if order == 3 and not prefiltered:
        coeff = spline_prefilter_2d(data.cpu().numpy(), periodic_x=wrap_x)
        data = torch.as_tensor(coeff, dtype=data.dtype, device=data.device)
    lead, (ny, nx) = data.shape[:-2], data.shape[-2:]
    flat = data.reshape(-1, ny, nx)
    if data.is_complex():
        table = torch.view_as_real(flat).permute(1, 2, 0, 3).reshape(ny, nx, -1)
    else:
        table = flat.permute(1, 2, 0)
    out = beam_eval(table.contiguous(), y, x, order=order, wrap_x=wrap_x)
    if data.is_complex():
        out = torch.view_as_complex(out.reshape(out.shape[0], -1, 2).contiguous())
    return out.T.reshape(lead + (out.shape[0],))
