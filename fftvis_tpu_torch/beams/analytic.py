"""Analytic primary beams, evaluated on tensors.

The port of ``fftvis_tpu/beams/analytic.py``. Conventions follow pyuvdata:

  - E-field beams have Naxes_vec = 2 and Nfeeds = 2; for these
    azimuthally-symmetric beams every (vec, feed) component is
    amplitude / sqrt(2), so the power beam is amplitude^2.
  - GaussianBeam(diameter) uses pyuvdata's diameter_to_sigma mapping
    sigma = 2/2.355 * arcsin(2.2 * lambda / (pi * diameter)); the E-field
    amplitude is exp(-za^2 / (2 sigma^2)).
  - AiryBeam(diameter): 2 J1(x)/x with x = pi * diameter * sin(za) * f / c.

``freq`` is a host float: frequency-dependent widths are computed in
float64 on the host and the evaluation runs in the tensor's dtype. ``power``
gives the (nsrc,) single-feed power, ``efield`` the (2 vec, 2 feed, nsrc)
complex Jones response.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.utils import speed_of_light
from .gridded import GriddedBeam


def bessel_j1(x: torch.Tensor) -> torch.Tensor:
    """Bessel function of the first kind, order 1 (A&S 9.4.4-9.4.6).

    Absolute accuracy ~< 1e-7 everywhere (the classic single-precision
    rational fits) -- the same fits as the JAX package, adequate for beam
    amplitudes.
    """
    ax = torch.abs(x)

    # |x| < 8: rational polynomial fit.
    y = x * x
    num = x * (
        72362614232.0
        + y
        * (
            -7895059235.0
            + y
            * (
                242396853.1
                + y * (-2972611.439 + y * (15704.48260 + y * (-30.16036606)))
            )
        )
    )
    den = 144725228442.0 + y * (
        2300535178.0
        + y * (18583304.74 + y * (99447.43394 + y * (376.9991397 + y)))
    )
    small = num / den

    # |x| >= 8: asymptotic form.
    safe = torch.clamp(ax, min=1e-30)
    z = 8.0 / safe
    y2 = z * z
    xx = ax - 2.356194491
    p0 = (
        1.0
        + y2
        * (0.183105e-2 + y2 * (-0.3516396496e-4 + y2 * (0.2457520174e-5 + y2 * (-0.240337019e-6))))
    )
    q0 = 0.04687499995 + y2 * (
        -0.2002690873e-3 + y2 * (0.8449199096e-5 + y2 * (-0.88228987e-6 + y2 * 0.105787412e-6))
    )
    big = (
        torch.sqrt(0.636619772 / safe)
        * (torch.cos(xx) * p0 - z * torch.sin(xx) * q0)
        * torch.sign(x)
    )
    return torch.where(ax < 8.0, small, big)


def diameter_to_sigma(diameter: float, freq: float) -> float:
    """pyuvdata's Gaussian-width-from-dish-diameter mapping (host float)."""
    wavelength = speed_of_light / freq
    scale = 2.2  # pyuvdata's Airy-to-Gaussian width ratio
    return float(np.arcsin(scale * wavelength / (np.pi * diameter)) * 2.0 / 2.355)


class AnalyticBeam:
    """Base class: azimuthally-symmetric unpolarized analytic E-field beam."""

    beam_type = "efield"

    def amplitude(self, za: torch.Tensor, freq: float) -> torch.Tensor:
        """Scalar E-field amplitude at zenith angle ``za``."""
        raise NotImplementedError

    def efield(self, az, za, freq: float) -> torch.Tensor:
        """Jones response, shape (2 vec, 2 feed, nsrc) complex."""
        amp = torch.broadcast_to(self.amplitude(za, freq) / np.sqrt(2.0), az.shape)
        amp = torch.broadcast_to(amp[None, None, :], (2, 2, amp.shape[0]))
        return torch.complex(amp, torch.zeros_like(amp))

    def power(self, az, za, freq: float, feed: str = "x") -> torch.Tensor:
        """Power response for a single feed, shape (nsrc,) real."""
        del az, feed  # symmetric beams: feeds identical
        return self.amplitude(za, freq) ** 2


class GaussianBeam(AnalyticBeam):
    """Gaussian beam, from an explicit sigma or a dish diameter.

    Parameters mirror pyuvdata: exactly one of ``sigma`` / ``diameter``;
    ``spectral_index`` scales sigma as (f / reference_frequency)^alpha.
    """

    def __init__(
        self,
        diameter: float | None = None,
        sigma: float | None = None,
        spectral_index: float = 0.0,
        reference_frequency: float | None = None,
    ):
        if (diameter is None) == (sigma is None):
            raise ValueError("GaussianBeam needs exactly one of diameter/sigma.")
        if spectral_index != 0.0 and reference_frequency is None:
            raise ValueError("spectral_index requires reference_frequency.")
        self.diameter = diameter
        self.sigma = sigma
        self.spectral_index = spectral_index
        self.reference_frequency = reference_frequency

    def _sigma(self, freq: float) -> float:
        if self.diameter is not None:
            return diameter_to_sigma(self.diameter, freq)
        sigma = self.sigma
        if self.spectral_index != 0.0:
            sigma = sigma * (freq / self.reference_frequency) ** self.spectral_index
        return float(sigma)

    def amplitude(self, za, freq):
        sigma = self._sigma(freq)
        return torch.exp(-(za**2) / (2.0 * sigma**2))


class AiryBeam(AnalyticBeam):
    """Uniform-disk (Airy) beam for a dish of the given diameter (m)."""

    def __init__(self, diameter: float):
        self.diameter = diameter

    def amplitude(self, za, freq):
        x = (np.pi * self.diameter * freq / speed_of_light) * torch.sin(za)
        small = torch.abs(x) < 1e-6
        xs = torch.where(small, torch.ones_like(x), x)
        return torch.where(small, 1.0 - x * x / 8.0, 2.0 * bessel_j1(xs) / xs)


class UniformBeam(AnalyticBeam):
    """Unit response everywhere (above and below horizon alike)."""

    def amplitude(self, za, freq):
        return torch.ones_like(za)


class ShortDipoleBeam(AnalyticBeam):
    """Crossed short (Hertzian) dipoles: a polarized analytic beam.

    Feed x is an east-west dipole, feed y north-south; components follow the
    (az, za) basis with the UVBeam azimuth convention (east = 0,
    counterclockwise toward north).
    """

    def efield(self, az, za, freq):
        caz, saz = torch.cos(az), torch.sin(az)
        cza = torch.cos(za)
        # rows: vec (az, za); cols: feed (x, y)
        row_az = torch.stack([-saz, caz], dim=0)  # (2 feed, n)
        row_za = torch.stack([cza * caz, cza * saz], dim=0)
        e = torch.stack([row_az, row_za], dim=0)  # (2, 2, n)
        return torch.complex(e, torch.zeros_like(e))

    def power(self, az, za, freq, feed: str = "x"):
        e = self.efield(az, za, freq)
        fi = {"x": 0, "y": 1}[feed]
        return torch.sum(torch.abs(e[:, fi, :]) ** 2, dim=0)


_BY_NAME = {
    "GaussianBeam": lambda b: GaussianBeam(
        diameter=b.diameter, sigma=b.sigma, spectral_index=b.spectral_index,
        reference_frequency=b.reference_frequency,
    ),
    "AiryBeam": lambda b: AiryBeam(diameter=b.diameter),
    "UniformBeam": lambda b: UniformBeam(),
    "ShortDipoleBeam": lambda b: ShortDipoleBeam(),
}


def beam_from_reference(beam):
    """The port's counterpart of a ``fftvis_tpu`` analytic or gridded beam.

    Maps by class name and parameters (reads attributes only; never imports
    the JAX package). A tabulated ``GriddedBeam`` maps onto the port's
    :class:`~fftvis_tpu_torch.beams.gridded.GriddedBeam` with the same
    arrays; any other class raises ``TypeError``.
    """
    if type(beam).__name__ == "GriddedBeam":
        return GriddedBeam(beam.data_array, beam.axis1_array, beam.axis2_array,
                           beam.freq_array, beam.beam_type, feeds=beam.feeds)
    make = _BY_NAME.get(type(beam).__name__)
    if make is None:
        raise TypeError(f"{type(beam).__name__} is not an analytic beam of the port")
    return make(beam)
