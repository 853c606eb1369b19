"""Synthetic structured E-field beams (test assets).

A NumPy copy of ``fftvis_tpu/beams/synth.py``: ``structured_dipole_beam``
(an Airy-like main lobe over a crossed-dipole vector pattern, sidelobes
with deep nulls, complex cross-polarization leakage, azimuthal ripple and a
slowly varying phase) and ``perturbed_variants``. The committed asset
``tests/data/structured_dipole_100MHz.beamfits`` is variant 0.
"""

from __future__ import annotations

import numpy as np

from .gridded import GriddedBeam


def _airy(x: np.ndarray) -> np.ndarray:
    """2 J1(x) / x, J1 via its ascending series + asymptotic form
    (accurate to ~1e-8 for |x| < 40)."""
    x = np.asarray(x, dtype=float)
    out = np.empty_like(x)
    small = np.abs(x) < 1e-6
    out[small] = 1.0
    xs = np.where(small, 1.0, x)

    ser_mask = np.abs(x) < 12.0
    j1 = np.zeros_like(x)
    if ser_mask.any():
        z = xs[ser_mask]
        term = z / 2.0
        acc = term.copy()
        half_z2 = (z / 2.0) ** 2
        for k in range(1, 30):
            term = -term * half_z2 / (k * (k + 1))
            acc += term
        j1[ser_mask] = acc
    if (~ser_mask).any():
        z = xs[~ser_mask]
        # Hankel asymptotic expansion, two terms.
        chi = z - 3.0 * np.pi / 4.0
        p = 1.0 + 15.0 / (128.0 * z**2)
        q = 3.0 / (8.0 * z) - 105.0 / (1024.0 * z**3)
        j1[~ser_mask] = np.sqrt(2.0 / (np.pi * z)) * (
            p * np.cos(chi) - q * np.sin(chi)
        )
    out[~small] = 2.0 * j1[~small] / xs[~small]
    out[small] = 1.0
    return out


def structured_dipole_beam(
    freq_hz: float = 1.0e8,
    diameter: float = 14.0,
    n_az: int = 360,
    n_za: int = 91,
    variant: int = 0,
    cross_pol_db: float = -22.0,
    ripple: float = 0.04,
    dtype=np.complex64,
) -> GriddedBeam:
    """A structured crossed-dipole E-field beam on a (az, za) grid.

    Envelope ``2 J1(x)/x`` with ``x = pi D (nu/c) sin za`` plus a -45 dB
    floor; crossed-dipole vector pattern; ``sin 2 az`` cross-pol leakage at
    ``cross_pol_db``; azimuthal ripple; an ``exp(i phi sin^2 za)`` phase.
    ``variant`` shifts the ripple/leakage phases deterministically.
    """
    c = 299792458.0
    az = np.linspace(0.0, 2 * np.pi, n_az, endpoint=False)
    za = np.linspace(0.0, np.pi / 2.0, n_za)
    azg, zag = np.meshgrid(az, za)  # (nza, naz)

    x = np.pi * diameter * (freq_hz / c) * np.sin(zag)
    envelope = _airy(x)
    envelope = envelope + 0.006 * np.cos(zag) ** 2

    p1 = 0.7 * variant + 0.31
    p2 = 1.3 * variant + 1.07
    rip = 1.0 + ripple * (
        np.cos(3.0 * azg + p1) + 0.5 * np.sin(7.0 * azg + p2)
    )
    phase = np.exp(1j * (0.35 + 0.02 * variant) * np.sin(zag) ** 2)
    amp = envelope * rip * phase

    eps = 10.0 ** (cross_pol_db / 20.0) * np.exp(1j * (0.3 + 0.05 * variant))
    leak = eps * np.sin(2.0 * azg + 0.2 * variant) * envelope

    cosz = np.cos(zag)
    data = np.zeros((2, 2, 1, n_za, n_az), dtype=np.complex128)
    # Feed x (east dipole): (E_az, E_za) co-pol + leakage into E_za.
    data[0, 0, 0] = amp * np.cos(azg) + leak * 0.3
    data[1, 0, 0] = -amp * np.sin(azg) * cosz + leak
    # Feed y (north dipole): rotate the dipole by 90 deg.
    data[0, 1, 0] = amp * np.sin(azg) - leak * 0.3
    data[1, 1, 0] = amp * np.cos(azg) * cosz + leak
    out = np.ascontiguousarray(data.astype(dtype))
    out.setflags(write=False)
    return GriddedBeam(
        out, az, za, np.array([float(freq_hz)]), "efield", feeds=["x", "y"]
    )


def perturbed_variants(base: GriddedBeam, n: int) -> list[GriddedBeam]:
    """``n`` per-antenna variants of a loaded base table: each multiplies
    the data by a small (0.5-2%) smooth az/za-dependent complex field."""
    az = base.axis1_array
    za = base.axis2_array
    azg, zag = np.meshgrid(az, za)
    out = []
    for i in range(n):
        if i == 0:
            out.append(base)
            continue
        pert = (
            1.0
            + 0.01 * np.cos(2.0 * azg + 0.9 * i)
            + 0.005 * np.sin(zag * 4.0 + 0.4 * i)
            + 1j * 0.004 * np.sin(azg + 0.7 * i)
        )
        data = base.data_array * pert[None, None, None, :, :]
        data = np.ascontiguousarray(data.astype(base.data_array.dtype))
        data.setflags(write=False)
        out.append(
            GriddedBeam(
                data, az, za, base.freq_array, base.beam_type,
                feeds=base.feeds,
            )
        )
    return out
