"""Per-time horizon-band block skipping (host planner).

A NumPy copy of ``fftvis_tpu/coords/banding.py``. For long observations
only part of the (statically culled) catalog is above the horizon at any one
time, yet an unbanded loop beam-evaluates and spreads every source block at
every time, relying on the mask to zero the invisible part. The planner:

1. reorders the catalog: always-visible sources first, then
   sometimes-visible sources sorted by (visibility duty-cycle class, RA), so
   that sources visible at the same times share contiguous blocks;
2. computes exactly on the host (float64, the device's rotation chain, with
   a keep-side margin for aberration and float32 jitter) which of the fixed
   source blocks hold any visible source at each time;
3. returns the per-time table of active block indices, padded to the most
   active blocks of any time with weight 0.

The engine (``cuda/engine.py``) applies the permutation and the device loop
(``cuda/program.py``) runs, at each time, only that time's active blocks.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


def plan_horizon_bands(
    rot,
    block: int,
    nblocks: int,
    nsrc_pad: int,
    margin: float = 2e-3,
    min_saving: float = 0.15,
):
    """Plan per-time active source blocks.

    Parameters
    ----------
    rot
        :class:`~fftvis_tpu_torch.coords.rotation.SourceRotation` (already
        culled). Not mutated: the caller applies the returned permutation
        to ``rot.eq_vectors`` and the fluxes.
    block, nblocks, nsrc_pad
        The source blocking: ``nblocks`` blocks of ``block`` sources,
        ``nsrc_pad = block * nblocks`` (the sources past ``rot.nsrc`` are
        padding, never visible).
    margin
        Keep-side zenith-cosine margin: a block counts as active when any
        of its sources rises above ``z > -margin`` (the semantics of
        ``cull_never_visible``).
    min_saving
        Return None (no banding) unless ``1 - K / nblocks`` reaches this
        fraction, K the most blocks active at any one time.

    Returns
    -------
    None, or ``(perm, active_idx, active_val)`` with ``perm`` an (nsrc,)
    permutation of the catalog, ``active_idx`` (ntimes, K) int32 and
    ``active_val`` (ntimes, K) float32 (0.0 marks padding rows).
    """
    nsrc = rot.nsrc
    ntimes = rot.ntimes
    if nsrc == 0 or ntimes < 2 or nblocks < 2:
        return None

    # Per-(time, source) visibility from the exact float64 zenith-cosine
    # chain, thresholded row by row: the full (ntimes, nsrc) float64 matrix
    # would cost 8x the bool table.
    vis = np.empty((ntimes, nsrc), dtype=bool)
    for t in range(ntimes):
        vis[t] = rot.topo_at(t)[2] > -margin

    always = vis.all(axis=0)
    some = ~always
    if not some.any():
        return None  # everything circumpolar: nothing to skip

    # Sort the sometimes-up set by (duty-cycle class, RA). RA comes from
    # the (culled) ICRS vectors; the duty cycle is the exact fraction of
    # simulated times the source is visible.
    eq = rot.eq_vectors
    ra = np.mod(np.arctan2(eq[1], eq[0]), 2 * np.pi)
    some_idx = np.flatnonzero(some)
    duty = vis[:, some_idx].mean(axis=0)
    n_classes = int(np.clip(nblocks // 8, 2, 16))
    # Quantile class edges keep classes equally populated.
    qs = np.quantile(duty, np.linspace(0, 1, n_classes + 1)[1:-1])
    cls = np.searchsorted(qs, duty, side="right")
    order = np.lexsort((ra[some_idx], cls))
    perm = np.concatenate([np.flatnonzero(always), some_idx[order]])

    visp = vis[:, perm]
    pad = nsrc_pad - nsrc
    if pad:
        visp = np.pad(visp, ((0, 0), (0, pad)))
    actb = visp.reshape(ntimes, nblocks, block).any(axis=2)  # (nt, nb)
    counts = actb.sum(axis=1)
    K = int(counts.max())
    saved = 1.0 - K / nblocks
    if K == 0 or saved < min_saving:
        return None

    active_idx = np.zeros((ntimes, K), dtype=np.int32)
    active_val = np.zeros((ntimes, K), dtype=np.float32)
    for t in range(ntimes):
        ids = np.flatnonzero(actb[t])
        active_idx[t, : ids.size] = ids
        active_val[t, : ids.size] = 1.0

    logger.info(
        "horizon banding: at most %d of %d source blocks per time "
        "(%.0f%% of the worst time's block work skipped) over %d times",
        K, nblocks, 100.0 * saved, ntimes,
    )
    return perm, active_idx, active_val
