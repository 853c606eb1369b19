"""Eigenbeam (SVD) basis decomposition.

A NumPy copy of ``fftvis_tpu/core/beam_basis.py`` on the port's beam
classes: N heterogeneous antenna beams become K "eigenbeams" plus per-beam
coefficients, which ``simulate_vis(beam=eigenbeams, beam_coefs=...)`` runs
as the K(K+1)/2-channel basis path. Analytic beams are evaluated on the
common grid through :meth:`BeamInterface.compute_response` (float64, on the
CPU). The tests hold its rank, singular values and reconstruction to the
original's.
"""

from __future__ import annotations

import logging

import numpy as np

from ..beams.gridded import GriddedBeam
from ..beams.interface import BeamInterface, prepare_beam_unpolarized

logger = logging.getLogger(__name__)


def compute_beam_basis(
    beam_list,
    freq: float,
    polarized: bool,
    threshold: float = 1e-12,
    axis1_array=None,
    axis2_array=None,
    n_axis1: int = 361,
    n_axis2: int = 181,
):
    """SVD beam basis for a collection of antenna beams.

    Each beam is evaluated on a common (az, za) grid at one frequency,
    flattened, and decomposed: retained right-singular vectors become
    eigenbeams (as GriddedBeam objects) and ``U @ diag(s)`` gives the
    per-input-beam coefficients.

    Returns
    -------
    eigenbeams : list of GriddedBeam
    beam_coefs : (n_beams, K) ndarray
    """
    if len(beam_list) == 0:
        raise ValueError("beam_list must contain at least one beam.")
    if not (0.0 < threshold <= 1.0):
        raise ValueError("threshold must be in the interval (0, 1].")

    freq_grid = np.atleast_1d(np.asarray(freq, dtype=float))
    if freq_grid.size != 1:
        raise ValueError("compute_beam_basis currently expects a scalar freq.")

    interfaces = []
    for bm in beam_list:
        bi = bm if isinstance(bm, BeamInterface) else BeamInterface(bm)
        if polarized:
            if bi.beam_type != "efield":
                raise ValueError("polarized=True requires efield beams.")
        else:
            bi = prepare_beam_unpolarized(bi)
        interfaces.append(bi)

    if (axis1_array is None) != (axis2_array is None):
        raise ValueError("axis1_array and axis2_array must be supplied together.")

    if axis1_array is None:
        for bi in interfaces:
            if bi._isuvbeam:
                axis1_array = bi.beam.axis1_array
                axis2_array = bi.beam.axis2_array
                break
        else:
            axis1_array = np.linspace(0.0, 2.0 * np.pi, n_axis1)
            axis2_array = np.linspace(0.0, np.pi, n_axis2)

    axis1_array = np.asarray(axis1_array, dtype=float)
    axis2_array = np.asarray(axis2_array, dtype=float)

    # Evaluate every beam on the common grid at the target frequency.
    azg, zag = np.meshgrid(axis1_array, axis2_array)  # (nza, naz)
    slices = []
    for bi in interfaces:
        resp = bi.compute_response(azg.ravel(), zag.ravel(), freq_grid)  # (nvec, nfeed, 1, npix)
        slices.append(resp[:, :, 0, :].reshape(
            resp.shape[0], resp.shape[1], len(axis2_array), len(axis1_array)))

    shape = slices[0].shape
    for i, s in enumerate(slices):
        if s.shape != shape:
            raise ValueError(f"Beam {i} evaluates to shape {s.shape}, expected {shape}.")

    stacked = np.stack([s.ravel() for s in slices], axis=0)  # (nbeams, npix*)
    U, s, Vh = np.linalg.svd(stacked, full_matrices=False)

    keep = int(np.sum(s / s[0] >= threshold))
    beam_coefs = U[:, :keep] * s[:keep][None, :]

    eigenbeams = []
    beam_type = "efield" if polarized else "power"
    for k in range(keep):
        data = Vh[k].reshape(shape)[:, :, None, :, :]  # add freq axis
        eigenbeams.append(GriddedBeam(data if polarized else data.real, axis1_array,
                                      axis2_array, freq_grid, beam_type=beam_type))
    logger.info("Retained %d/%d eigenbeams at threshold %g", keep, len(beam_list), threshold)
    return eigenbeams, beam_coefs
