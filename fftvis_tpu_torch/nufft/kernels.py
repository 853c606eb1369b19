"""Exponential-of-semicircle (ES) spreading kernel: parameters and transforms.

The port's copy of ``fftvis_tpu/nufft/kernels.py`` (Barnett et al.,
arXiv:1808.06736):

    phi(z) = exp(beta * (sqrt(1 - z^2) - 1)),   |z| <= 1
    psi(t) = phi(2 t / w),                      |t| <= w/2   (grid units)

The host functions (width/beta selection, the quadrature Fourier transform,
the log-Chebyshev fit, FFT sizes) are NumPy copies that give exactly the
arrays of the JAX package. The evaluators ``es_kernel``, ``es_kernel_grid``,
``es_kernel_ft`` and ``es_kernel_ft_cheb`` take NumPy arrays or torch
tensors and compute in the tensor's own dtype and device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

MAX_WIDTH = 16
MIN_WIDTH = 2

# Quadrature order for the kernel Fourier transform. The integrand is
# exp(beta sqrt(1-z^2)) cos(a z) with |a| <= pi/sigma * w/2 <~ 26; 80 nodes
# hold ~1e-15 accuracy over the full range.
_QUAD_NODES = 80


def kernel_width(eps: float, sigma: float) -> int:
    """Kernel half-support in grid points for target accuracy ``eps``."""
    if sigma == 2.0:
        w = int(np.ceil(np.log10(1.0 / eps))) + 1
    else:
        # Low-upsampling kernels lose ~half a digit in practice; widen by one.
        w = 1 + int(
            np.ceil(np.log(1.0 / eps) / (np.pi * np.sqrt(1.0 - 1.0 / sigma)))
        )
    return int(np.clip(w, MIN_WIDTH, MAX_WIDTH))


def kernel_beta(w: int, sigma: float) -> float:
    """ES kernel sharpness parameter."""
    if sigma == 2.0:
        gamma_w = {2: 2.20, 3: 2.26, 4: 2.38}.get(w, 2.30)
        return gamma_w * w
    return float(np.pi * w * (1.0 - 1.0 / (2.0 * sigma)) * 0.976)


@dataclass(frozen=True)
class ESKernel:
    """ES kernel configuration for one transform."""

    w: int
    beta: float
    sigma: float
    eps: float

    @classmethod
    def from_eps(cls, eps: float, sigma: float = 2.0) -> "ESKernel":
        if sigma not in (1.25, 2.0):
            raise ValueError("upsample_factor (sigma) must be 1.25 or 2")
        w = kernel_width(eps, sigma)
        return cls(w=w, beta=kernel_beta(w, sigma), sigma=sigma, eps=eps)


def es_kernel(z, beta: float):
    """phi(z) on |z|<=1, zero outside. NumPy array or torch tensor."""
    xp = torch if isinstance(z, torch.Tensor) else np
    inside = xp.abs(z) < 1.0
    safe = xp.where(inside, z, 0.0)
    val = xp.exp(beta * (xp.sqrt(1.0 - safe * safe) - 1.0))
    return xp.where(inside, val, 0.0)


def es_kernel_grid(t, w: int, beta: float):
    """psi(t) = phi(2t/w) for offsets t in grid units."""
    return es_kernel(2.0 * t / w, beta)


@functools.lru_cache(maxsize=None)
def _gl_nodes(n: int) -> tuple[tuple[float, ...], tuple[float, ...]]:
    x, wts = np.polynomial.legendre.leggauss(n)
    return tuple(x), tuple(wts)


@functools.lru_cache(maxsize=None)
def _gl_tensors(dtype: torch.dtype, device: torch.device):
    """The quadrature nodes and weights on a device, uploaded once: a
    per-call upload would make the host wait for the card."""
    nodes, weights = _gl_nodes(_QUAD_NODES)
    return (torch.tensor(nodes, dtype=dtype, device=device),
            torch.tensor(weights, dtype=dtype, device=device))


def es_kernel_ft(xi, w: int, beta: float):
    """Fourier transform of the grid-unit kernel, psi_hat(xi).

    psi_hat(xi) = int_{-w/2}^{w/2} psi(t) e^{-i xi t} dt
                = (w/2) * int_{-1}^{1} e^{beta(sqrt(1-z^2)-1)} cos(xi w z / 2) dz

    ``xi`` is in radians per grid point. A tensor ``xi`` keeps its dtype
    and device (the quadrature table follows it); NumPy input computes in
    float64.
    """
    nodes, weights = _gl_nodes(_QUAD_NODES)
    if isinstance(xi, torch.Tensor):
        z, q = _gl_tensors(xi.dtype, xi.device)
        envelope = torch.exp(beta * (torch.sqrt(1.0 - z * z) - 1.0)) * q
        phases = xi[..., None] * (0.5 * w) * z
        return (0.5 * w) * torch.sum(torch.cos(phases) * envelope, dim=-1)
    xi = np.asarray(xi)
    z = np.asarray(nodes, dtype=np.float64)
    q = np.asarray(weights, dtype=np.float64)
    envelope = np.exp(beta * (np.sqrt(1.0 - z * z) - 1.0)) * q
    phases = xi[..., None] * (0.5 * w) * z  # (..., nq)
    return (0.5 * w) * np.sum(np.cos(phases) * envelope, axis=-1)


def fit_log_ft_cheb(
    w: int,
    beta: float,
    xi_max: float,
    tol: float = 3e-7,
    degrees: tuple = (12, 16, 20, 24, 32, 40),
):
    """Host-side Chebyshev fit of log(psi_hat) over |xi| <= xi_max.

    The type-3 amplitude pre-correction divides per-source weights by
    psi_hat(x * ds); a degree-~20 Chebyshev of log(psi_hat) in
    t = 2 (xi/xi_max)^2 - 1 is one Clenshaw recurrence and one exp instead
    of the 80-node quadrature. Fitting the LOG keeps the error RELATIVE
    across psi_hat's decay.

    Returns float64 Chebyshev coefficients, or None when the fit cannot
    reach ``tol`` (the caller then uses the quadrature) or psi_hat is not
    strictly positive on the domain.
    """
    from numpy.polynomial import chebyshev as _cheb

    xi = np.linspace(0.0, float(xi_max), 4001)
    ph = es_kernel_ft(xi, w, beta)
    if ph.min() <= 0:
        return None
    lp = np.log(ph)
    t = 2.0 * (xi / xi_max) ** 2 - 1.0
    for deg in degrees:
        coefs = _cheb.chebfit(t, lp, deg)
        if np.abs(_cheb.chebval(t, coefs) - lp).max() < tol:
            return coefs
    return None


def es_kernel_ft_cheb(xi, coefs, xi_max: float):
    """Evaluate the :func:`fit_log_ft_cheb` approximation of psi_hat(xi).

    Clenshaw recurrence in the tensor's dtype; |xi| beyond xi_max clips to
    the domain edge (the plan's extent bounds all live coordinates).
    """
    r = xi * (1.0 / xi_max)
    t = torch.clamp(2.0 * r * r - 1.0, -1.0, 1.0)
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    t2 = 2.0 * t
    for c in coefs[:0:-1]:
        b1, b2 = t2 * b1 - b2 + float(c), b1
    return torch.exp(t * b1 - b2 + float(coefs[0]))


def next_fast_size(n: int, prefer_pow2: bool = False, multiple_of: int = 8) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) multiple of ``multiple_of`` >= n.

    cuFFT handles radix-2/3/5 well; the multiple-of-8 default keeps the
    planned grids identical to the JAX package's.
    """
    if prefer_pow2:
        return max(1 << int(np.ceil(np.log2(max(n, 2)))), multiple_of)
    n = max(int(n), multiple_of)
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1 and n % multiple_of == 0:
            return n
        n += 1
