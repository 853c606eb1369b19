"""Sky coherency formation.

The port of ``fftvis_tpu/core/coherency.py`` for the slice: the host
Stokes -> coherency conversion (NumPy, unpolarized and IQUV), and the
unpolarized apparent-coherency rows on tensors. Polarized rows are ROADMAP
item 6.
"""

from __future__ import annotations

import numpy as np
import torch


def classify_sky(sky_model: np.ndarray, polarized_beam: bool) -> bool:
    """Validate a sky model's layout; return whether it is IQUV-polarized.

    Error messages match the reference (its tests assert on them).
    """
    if sky_model.ndim == 2:
        return False
    if polarized_beam and sky_model.ndim == 3 and sky_model.shape[-1] == 4:
        return True
    if polarized_beam:
        raise ValueError(
            f"polarized_beam=True requires sky_model to be either:\n"
            f"  2D unpolarized, or\n"
            f"  3D with last axis of length 4; "
            f"got ndim={sky_model.ndim}, shape={sky_model.shape}"
        )
    raise ValueError(
        f"polarized_beam=False requires sky_model to be 2D; "
        f"got ndim={sky_model.ndim}, shape={sky_model.shape}"
    )


def build_coherency(sky_model: np.ndarray, polarized_sky: bool) -> np.ndarray:
    """Source coherency: (nsrc, nfreq) Stokes-I or (nsrc, nfreq, 2, 2) IQUV."""
    if not polarized_sky:
        return 0.5 * sky_model
    I, Q, U, V = (sky_model[..., i] for i in range(4))
    return 0.5 * np.stack(
        [
            np.stack([I + Q, U + 1j * V], axis=-1),
            np.stack([U - 1j * V, I - Q], axis=-1),
        ],
        axis=-2,
    )  # (nsrc, nfreq, 2, 2)


def apparent_coherency_rows(e_i, e_j, flux, polarized: bool = False,
                            polarized_sky: bool = False) -> torch.Tensor:
    """Beam-weighted source coherency for one beam pair, as NUFFT rows.

    ``e_i``, ``e_j``: (nsrc,) real power responses; ``flux``: (nsrc,) real.
    Returns (1, nsrc) complex rows, the layout the reference feeds its NUFFT.
    """
    if polarized or polarized_sky:
        raise NotImplementedError("polarized coherency rows are ROADMAP item 6")
    # Cubic interpolation of a tabulated power beam can overshoot to small
    # negatives near nulls; clamp at zero (the physical floor).
    amp = torch.sqrt(torch.clamp(e_i * e_j, min=0.0)) * flux
    return torch.complex(amp, torch.zeros_like(amp))[None, :]
