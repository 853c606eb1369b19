"""Integer-lattice detection for antenna layouts.

If the 2D antenna positions sit on an integer lattice (after a linear change
of basis), every baseline becomes an integer vector and ALL visibilities can
be read off a single uniform FFT (type-1 NUFFT path) instead of one type-3
transform per baseline set. This is the highest-leverage algorithmic path for
gridded arrays (HERA-like hexes).

A NumPy copy of ``fftvis_tpu/core/antenna_gridding.py``; the port uses it
to detect gridded arrays, which this slice refuses without
``force_use_type3`` (their type-1 path is a later slice).
"""

from __future__ import annotations

from fractions import Fraction
from math import lcm

import numpy as np


def find_integer_multiplier(arr: np.ndarray, max_denominator: int = 10**6) -> int:
    """Smallest positive integer f with f*arr integral (rational approximation).

    Zeros are ignored. (ref core/antenna_gridding.py:7-35)
    """
    denominators = [
        Fraction(float(v)).limit_denominator(max_denominator).denominator
        for v in np.ravel(arr)
        if v != 0
    ]
    if not denominators:
        return 1
    return lcm(*denominators)


def can_scale_to_int(
    arr: np.ndarray,
    tol: float = 1e-9,
    max_denominator: int = 10**6,
    max_factor: int | None = None,
) -> tuple[bool, int]:
    """Whether an integer factor f exists making f*arr (approximately) integer.

    (ref core/antenna_gridding.py:38-72)
    """
    f = find_integer_multiplier(arr, max_denominator)
    if max_factor is not None and f > max_factor:
        return False, f
    scaled = f * np.asarray(arr, dtype=float)
    ok = bool(np.allclose(scaled, np.round(scaled), atol=tol))
    return ok, f


def find_lattice_basis(antpos: dict, tol: float = 1e-9):
    """Infer a candidate 2D lattice basis from antenna positions.

    Picks the shortest nonzero baseline and the shortest baseline not
    collinear with it. Returns a (2, 2) matrix whose COLUMNS are the basis
    vectors, or a fallback when all baselines are collinear, or ``None`` when
    there are no nonzero baselines. (ref core/antenna_gridding.py:74-137)
    """
    xy = np.array([np.asarray(antpos[a], dtype=float)[:2] for a in antpos])
    diffs = (xy[:, None, :] - xy[None, :, :]).reshape(-1, 2)
    norms = np.linalg.norm(diffs, axis=1)
    keep = norms > tol
    if not np.any(keep):
        return None

    diffs = diffs[keep]
    norms = norms[keep]
    order = np.argsort(norms)
    diffs = diffs[order]

    b1 = diffs[0]
    for v in diffs[1:]:
        cross = b1[0] * v[1] - b1[1] * v[0]
        if abs(cross) > tol:
            return np.column_stack([b1, v])
    # All collinear: complete the basis with a unit y vector.
    return np.vstack([b1, np.array([0.0, 1.0])])


def check_antpos_griddability(
    antpos: dict,
    tol: float = 1e-9,
    max_denominator: int = 10**6,
    max_factor: int = 1000,
):
    """Decide whether the antenna layout can be mapped to an integer lattice.

    Returns ``(is_griddable, antpos_out, transform)`` where, when griddable,
    ``antpos_out`` maps each antenna to integer lattice coordinates and
    ``transform`` is the 3x3 matrix sending lattice coordinates back to meters
    (scaled by 1/factor). (ref core/antenna_gridding.py:139-219)
    """
    keys = list(antpos.keys())
    antvecs = np.array([np.asarray(antpos[a], dtype=float) for a in keys])

    basis2 = find_lattice_basis(antpos, tol=tol)
    if basis2 is None:
        return False, antpos, np.eye(antvecs.shape[-1])

    basis = np.zeros((3, 3))
    basis[:2, :2] = basis2
    basis[2, 2] = 1.0

    in_basis = np.linalg.solve(basis, (antvecs - antvecs[0]).T).T

    ok, factor = can_scale_to_int(
        np.ravel(in_basis),
        tol=tol,
        max_denominator=max_denominator,
        max_factor=max_factor,
    )
    if not ok:
        return False, antpos, np.eye(antvecs.shape[-1])

    gridded = {
        a: np.round(factor * in_basis[i]).astype(int) for i, a in enumerate(keys)
    }
    return True, gridded, basis / factor
