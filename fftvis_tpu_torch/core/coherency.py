"""Sky coherency formation.

The port of ``fftvis_tpu/core/coherency.py``: the host Stokes -> coherency
conversion (NumPy, unpolarized and IQUV), and the apparent-coherency rows
on tensors, of one beam pair or of every pair of a beam stack at once --
power beams, Jones beams with a Stokes-I sky, and Jones beams with an IQUV
sky.
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

    ``e_i``, ``e_j``: (2 vec, 2 feed, nsrc) complex Jones responses when
    ``polarized``, else (nsrc,) real power responses. ``flux``: (nsrc,) real
    for a Stokes-I sky, or (nsrc, 2, 2) complex coherency for an IQUV sky
    (one frequency). Returns (nfeeds**2, nsrc) complex rows ordered
    (f1, f2) = (00, 01, 10, 11), the layout the reference feeds its NUFFT.
    """
    if polarized and polarized_sky:
        # The reference flips the vector-component axis of both Jones
        # matrices before A_i^H C A_j.
        ai = torch.conj(torch.flip(e_i, dims=(0,)))
        aj = torch.flip(e_j, dims=(0,))
        coh = torch.movedim(flux, 0, -1)  # (2, 2, nsrc)
        out = sum(
            ai[a, :, None, :] * coh[a, b][None, None, :] * aj[b, None, :, :]
            for a in range(2)
            for b in range(2)
        )  # (f, g, nsrc)
        return out.reshape(4, -1)
    if polarized:
        eic = torch.conj(e_i)
        out = (
            eic[0, :, None, :] * e_j[0, None, :, :]
            + eic[1, :, None, :] * e_j[1, None, :, :]
        ) * flux.to(e_i.dtype)[None, None, :]
        return out.reshape(4, -1)
    # Cubic interpolation of a tabulated power beam can overshoot to small
    # negatives near nulls; clamp at zero (the physical floor).
    amp = torch.sqrt(torch.clamp(e_i * e_j, min=0.0)) * flux
    return torch.complex(amp, torch.zeros_like(amp))[None, :]


def apparent_coherency_rows_batched(evals, idx_i, idx_j, flux, polarized: bool = False,
                                    polarized_sky: bool = False) -> torch.Tensor:
    """All beam-pair coherency rows at once.

    The batched form of :func:`apparent_coherency_rows`: ``evals`` stacks
    every beam's response, (K, 2 vec, 2 feed, nsrc) complex when
    ``polarized``, else (K, nsrc) real; ``idx_i``/``idx_j`` are the (P,)
    beam indices of the pairs. Returns (P * nfeeds**2, nsrc) complex rows,
    pair-major and (f1, f2) = (00, 01, 10, 11) within a pair: the order the
    per-pair concatenation gives. It is the plain version of the pair-rows
    kernel (:func:`~fftvis_tpu_torch.beams.eval.pair_rows`).
    """
    ii = torch.as_tensor(np.asarray(idx_i), dtype=torch.long, device=evals.device)
    jj = torch.as_tensor(np.asarray(idx_j), dtype=torch.long, device=evals.device)
    e_i, e_j = evals[ii], evals[jj]
    if polarized and polarized_sky:
        ai = torch.conj(torch.flip(e_i, dims=(1,)))
        aj = torch.flip(e_j, dims=(1,))
        coh = torch.movedim(flux, 0, -1)  # (2, 2, nsrc)
        out = sum(
            ai[:, a, :, None, :] * coh[a, b][None, None, None, :] * aj[:, b, None, :, :]
            for a in range(2)
            for b in range(2)
        )  # (P, f, g, nsrc)
    elif polarized:
        eic = torch.conj(e_i)
        out = (
            eic[:, 0, :, None, :] * e_j[:, 0, None, :, :]
            + eic[:, 1, :, None, :] * e_j[:, 1, None, :, :]
        ) * flux.to(e_i.dtype)[None, None, None, :]
    else:
        # See apparent_coherency_rows: clamp cubic-interpolation overshoot.
        amp = torch.sqrt(torch.clamp(e_i * e_j, min=0.0)) * flux[None, :]
        return torch.complex(amp, torch.zeros_like(amp))
    return out.reshape(out.shape[0] * 4, out.shape[-1])
