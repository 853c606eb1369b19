"""Standalone ICRS -> topocentric rotation ("ERFA-lite"), host NumPy.

A NumPy copy of ``fftvis_tpu/coords/erfa_lite.py`` (the port never imports
the JAX package); tests assert the two give identical arrays. The per-time
ICRS->ENU transform is a single 3x3 matrix, computed once on the host in
float64 and applied on the device as one batched matmul.

Model implemented (equinox-based chain):

    r_enu(t) = E(lat, lon) . R3(GAST(t)) . NPB(t) . A(t) . r_icrs

with
  - ``A``   annual aberration (first order, circular-orbit Earth velocity),
  - ``NPB`` frame bias + IAU 2006 precession (Fukushima-Williams angles) +
            truncated IAU 2000B nutation (largest luni-solar terms),
  - ``GAST = GMST(IAU 2006) + dpsi cos(eps)``,
  - ``E``   the ITRS->ENU basis at the telescope site.

Approximations (documented, not silent): UT1 == UTC (no DUT1), TT - UTC
fixed at 69.184 s (valid 2017+), nutation truncated to the ~20 largest terms
(error ~ few mas), no polar motion, no diurnal aberration, no light
deflection. Net pointing accuracy ~< 0.1 arcsec over decades around J2000,
far below primary-beam scales.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ARCSEC = np.pi / (180.0 * 3600.0)
TWO_PI = 2.0 * np.pi
JD_J2000 = 2451545.0
DAYS_PER_CENTURY = 36525.0
TT_MINUS_UTC_SEC = 69.184  # 32.184 + 37 leap seconds (2017+)

# Annual aberration constant (radians).
ABERRATION_KAPPA = 20.49552 * ARCSEC


@dataclass(frozen=True)
class TelescopeLocation:
    """Geodetic site. Angles in radians, height in meters."""

    lat: float
    lon: float
    height: float = 0.0

    @classmethod
    def from_any(cls, loc) -> "TelescopeLocation":
        """Coerce from a TelescopeLocation, an astropy EarthLocation-like
        object (duck-typed on .lat/.lon/.height), or a (lat, lon[, height])
        sequence in radians/meters."""
        if isinstance(loc, cls):
            return loc
        if hasattr(loc, "lat") and hasattr(loc, "lon"):
            def _rad(x):
                for attr in ("rad",):
                    if hasattr(x, attr):
                        return float(getattr(x, attr))
                if hasattr(x, "to_value"):
                    return float(x.to_value("rad"))
                return float(x)

            height = getattr(loc, "height", 0.0)
            if hasattr(height, "to_value"):
                height = float(height.to_value("m"))
            return cls(_rad(loc.lat), _rad(loc.lon), float(height))
        arr = np.asarray(loc, dtype=float).ravel()
        if arr.size == 2:
            return cls(arr[0], arr[1], 0.0)
        if arr.size == 3:
            return cls(arr[0], arr[1], arr[2])
        raise ValueError(
            "telescope_loc must be a TelescopeLocation, an EarthLocation-like "
            "object, or a (lat, lon[, height]) sequence in radians/meters."
        )


def times_to_jd(times) -> np.ndarray:
    """Coerce times to a float64 JD (UTC) array.

    Accepts plain JD arrays or astropy-Time-like objects (duck-typed .jd).
    """
    if hasattr(times, "jd"):
        return np.atleast_1d(np.asarray(times.jd, dtype=float))
    return np.atleast_1d(np.asarray(times, dtype=float))


def _r1(theta: np.ndarray) -> np.ndarray:
    """Rotation about x by +theta (frame rotation, ERFA convention)."""
    c, s = np.cos(theta), np.sin(theta)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [
            np.stack([o, z, z], -1),
            np.stack([z, c, s], -1),
            np.stack([z, -s, c], -1),
        ],
        -2,
    )


def _r3(theta: np.ndarray) -> np.ndarray:
    """Rotation about z by +theta (frame rotation, ERFA convention)."""
    c, s = np.cos(theta), np.sin(theta)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [
            np.stack([c, s, z], -1),
            np.stack([-s, c, z], -1),
            np.stack([z, z, o], -1),
        ],
        -2,
    )


def _fundamental_args(t: np.ndarray) -> tuple[np.ndarray, ...]:
    """Delaunay arguments (l, l', F, D, Om) in radians; t in TT centuries."""
    l = (485868.249036 + 1717915923.2178 * t) * ARCSEC
    lp = (1287104.79305 + 129596581.0481 * t) * ARCSEC
    f = (335779.526232 + 1739527262.8478 * t) * ARCSEC
    d = (1072260.70369 + 1602961601.2090 * t) * ARCSEC
    om = (450160.398036 - 6962890.5431 * t) * ARCSEC
    return l, lp, f, d, om


# Truncated IAU 2000B luni-solar nutation series: the ~20 largest terms.
# Columns: multipliers (l, l', F, D, Om), then longitude coefficients
# (sin, t*sin, cos) and obliquity coefficients (cos, t*cos, sin), in mas.
_NUTATION_TERMS = np.array(
    [
        # l  l'  F   D  Om    ps        pst     pc       ec       ect     es
        [0, 0, 0, 0, 1, -17206.4161, -17.4666, 3.3386, 9205.2331, 0.9086, 1.5377],
        [0, 0, 2, -2, 2, -1317.0906, -0.1675, -1.3696, 573.0336, -0.3015, -0.4587],
        [0, 0, 2, 0, 2, -227.6413, -0.0234, 0.2796, 97.8459, -0.0485, 0.1374],
        [0, 0, 0, 0, 2, 207.4554, 0.0207, -0.0698, -89.7492, 0.0470, -0.0291],
        [0, 1, 0, 0, 0, 147.5877, -0.3633, 1.1817, 7.3871, -0.0184, -0.1924],
        [0, 1, 2, -2, 2, -51.6821, 0.1226, -0.0524, 22.4386, -0.0677, -0.0174],
        [1, 0, 0, 0, 0, 71.1159, 0.0073, -0.0872, -0.6750, 0.0000, 0.0358],
        [0, 0, 2, 0, 1, -38.7298, -0.0367, 0.0380, 20.0728, 0.0018, 0.0318],
        [1, 0, 2, 0, 2, -30.1461, -0.0036, 0.0816, 12.9025, -0.0063, 0.0367],
        [0, -1, 2, -2, 2, 21.5829, -0.0494, 0.0111, -9.5929, 0.0299, 0.0132],
        [0, 0, 2, -2, 1, 12.8227, 0.0137, 0.0181, -6.8982, -0.0009, 0.0039],
        [-1, 0, 2, 0, 2, 12.3457, 0.0011, 0.0019, -5.3311, 0.0032, -0.0004],
        [-1, 0, 0, 2, 0, 15.6994, 0.0010, -0.0168, -0.0123, 0.0000, 0.0082],
        [1, 0, 0, 0, 1, 6.3110, 0.0063, 0.0027, -3.3228, 0.0000, -0.0009],
        [-1, 0, 0, 0, 1, -5.7976, -0.0063, -0.0189, 3.2355, 0.0000, -0.0075],
        [-1, 0, 2, 2, 2, -5.9641, -0.0011, 0.0149, 2.5700, -0.0001, 0.0066],
        [1, 0, 2, 0, 1, -5.1613, -0.0042, 0.0129, 2.6328, 0.0000, 0.0078],
        [-2, 0, 2, 0, 1, 4.5893, 0.0050, 0.0031, -2.4236, -0.0010, 0.0020],
        [0, 0, 0, 2, 0, 6.3384, 0.0011, -0.0150, -0.0038, 0.0000, 0.0029],
        [0, 0, 2, 2, 2, -3.8571, -0.0001, 0.0158, 1.6452, -0.0011, 0.0068],
    ]
)


def nutation_2000b_truncated(t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(dpsi, deps) in radians from the truncated IAU 2000B series."""
    l, lp, f, d, om = _fundamental_args(t)
    mult = _NUTATION_TERMS[:, :5]  # (nterm, 5)
    args = (
        mult[:, 0][:, None] * l
        + mult[:, 1][:, None] * lp
        + mult[:, 2][:, None] * f
        + mult[:, 3][:, None] * d
        + mult[:, 4][:, None] * om
    )  # (nterm, nt)
    sin_a, cos_a = np.sin(args), np.cos(args)
    ps, pst, pc = _NUTATION_TERMS[:, 5:8].T
    ec, ect, es = _NUTATION_TERMS[:, 8:11].T
    mas = 1e-3 * ARCSEC
    dpsi = np.sum(
        (ps[:, None] + pst[:, None] * t) * sin_a + pc[:, None] * cos_a, axis=0
    )
    deps = np.sum(
        (ec[:, None] + ect[:, None] * t) * cos_a + es[:, None] * sin_a, axis=0
    )
    # Fixed offsets standing in for planetary nutation (IAU 2000B practice).
    dpsi = dpsi * mas - 0.135 * mas
    deps = deps * mas + 0.388 * mas
    return dpsi, deps


def precession_fw_angles(t: np.ndarray) -> tuple[np.ndarray, ...]:
    """IAU 2006 Fukushima-Williams precession angles (radians)."""
    gamb = (
        -0.052928
        + 10.556378 * t
        + 0.4932044 * t**2
        - 0.00031238 * t**3
        - 0.000002788 * t**4
        + 0.0000000260 * t**5
    ) * ARCSEC
    phib = (
        84381.412819
        - 46.811016 * t
        + 0.0511268 * t**2
        + 0.00053289 * t**3
        - 0.000000440 * t**4
        - 0.0000000176 * t**5
    ) * ARCSEC
    psib = (
        -0.041775
        + 5038.481484 * t
        + 1.5584175 * t**2
        - 0.00018522 * t**3
        - 0.000026452 * t**4
        - 0.0000000148 * t**5
    ) * ARCSEC
    epsa = mean_obliquity(t)
    return gamb, phib, psib, epsa


def mean_obliquity(t: np.ndarray) -> np.ndarray:
    """IAU 2006 mean obliquity of the ecliptic (radians)."""
    return (
        84381.406
        - 46.836769 * t
        - 0.0001831 * t**2
        + 0.00200340 * t**3
        - 0.000000576 * t**4
        - 0.0000000434 * t**5
    ) * ARCSEC


def npb_matrix(t: np.ndarray) -> np.ndarray:
    """Bias-precession-nutation matrix (GCRS -> true equator/equinox of date).

    Fukushima-Williams composition with nutation folded into the angles
    (equivalent of ERFA fw2m(gamb, phib, psib+dpsi, epsa+deps)).
    """
    gamb, phib, psib, epsa = precession_fw_angles(t)
    dpsi, deps = nutation_2000b_truncated(t)
    return (
        _r1(-(epsa + deps)) @ _r3(-(psib + dpsi)) @ _r1(phib) @ _r3(gamb)
    )


def earth_rotation_angle(jd_ut1: np.ndarray) -> np.ndarray:
    """Earth rotation angle (radians) from UT1 Julian date."""
    d = jd_ut1 - JD_J2000
    frac = d % 1.0
    return TWO_PI * ((0.7790572732640 + 0.00273781191135448 * d + frac) % 1.0)


def gmst_2006(jd_ut1: np.ndarray, t_tt: np.ndarray) -> np.ndarray:
    """GMST (IAU 2006), radians."""
    poly = (
        0.014506
        + 4612.156534 * t_tt
        + 1.3915817 * t_tt**2
        - 0.00000044 * t_tt**3
        - 0.000029956 * t_tt**4
        - 0.0000000368 * t_tt**5
    ) * ARCSEC
    return (earth_rotation_angle(jd_ut1) + poly) % TWO_PI


def sun_ecliptic_longitude(t: np.ndarray) -> np.ndarray:
    """Apparent ecliptic longitude of the Sun (radians), low precision."""
    deg = np.pi / 180.0
    mean_lon = (280.46646 + 36000.76983 * t + 0.0003032 * t**2) * deg
    mean_anom = (357.52911 + 35999.05029 * t - 0.0001537 * t**2) * deg
    center = (
        (1.914602 - 0.004817 * t) * np.sin(mean_anom)
        + (0.019993 - 0.000101 * t) * np.sin(2 * mean_anom)
        + 0.000289 * np.sin(3 * mean_anom)
    ) * deg
    return mean_lon + center


def aberration_velocity(t: np.ndarray) -> np.ndarray:
    """Earth velocity / c in the equatorial frame, shape (nt, 3).

    First-order annual aberration with a circular-orbit Earth; the apex of
    motion sits 90 degrees behind the Sun's apparent ecliptic longitude.
    """
    lam = sun_ecliptic_longitude(t)
    eps = mean_obliquity(t)
    v_ecl = ABERRATION_KAPPA * np.stack(
        [np.sin(lam), -np.cos(lam), np.zeros_like(lam)], axis=-1
    )
    # Ecliptic -> equatorial: rotate about x by -eps (coordinate rotation).
    rot = _r1(-eps)  # frame rotation by -eps == coordinate rotation by +eps
    return np.einsum("tij,tj->ti", rot, v_ecl)


def enu_basis(lat: float, lon: float) -> np.ndarray:
    """Rows are the East, North, Up unit vectors in the ITRS frame."""
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    return np.array(
        [
            [-so, co, 0.0],
            [-sl * co, -sl * so, cl],
            [cl * co, cl * so, sl],
        ]
    )


def icrs_to_enu_matrices(jd_utc: np.ndarray, location) -> np.ndarray:
    """Per-time 3x3 matrices mapping ICRS unit vectors to topocentric ENU.

    Aberration is NOT folded in (the direction shift depends on the source
    direction, so it is not a single rotation); use
    :func:`aberration_velocities` and apply ``r' = normalize(r + v)`` on
    device before the matmul.

    Returns float64 array of shape (ntimes, 3, 3).
    """
    loc = TelescopeLocation.from_any(location)
    jd_utc = times_to_jd(jd_utc)
    jd_tt = jd_utc + TT_MINUS_UTC_SEC / 86400.0
    t = (jd_tt - JD_J2000) / DAYS_PER_CENTURY

    npb = npb_matrix(t)  # (nt, 3, 3)
    dpsi, _ = nutation_2000b_truncated(t)
    gast = gmst_2006(jd_utc, t) + dpsi * np.cos(mean_obliquity(t))
    spin = _r3(gast)  # (nt, 3, 3)
    site = enu_basis(loc.lat, loc.lon)  # (3, 3)

    return np.einsum("ij,tjk,tkl->til", site, spin, npb)


def aberration_velocities(jd_utc: np.ndarray) -> np.ndarray:
    """Per-time Earth velocity / c in the ICRS frame, shape (nt, 3).

    Apply on device as ``r' = normalize(r + v[t, :, None])`` before the
    ICRS->ENU matmul (first-order annual aberration, ~20.5 arcsec)."""
    jd = times_to_jd(jd_utc)
    t = (jd + TT_MINUS_UTC_SEC / 86400.0 - JD_J2000) / DAYS_PER_CENTURY
    return aberration_velocity(t)


def radec_to_icrs_vectors(ra: np.ndarray, dec: np.ndarray) -> np.ndarray:
    """(3, nsrc) unit vectors from ICRS ra/dec in radians."""
    cd = np.cos(dec)
    return np.stack([cd * np.cos(ra), cd * np.sin(ra), np.sin(dec)], axis=0)
