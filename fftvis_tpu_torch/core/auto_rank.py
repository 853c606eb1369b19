"""Accuracy-controlled automatic rank compression of per-antenna beam lists.

A NumPy copy of ``fftvis_tpu/core/auto_rank.py``. The per-antenna path costs
one transform channel per (beam pair, feed product), and the transforms are
linear in the channel count; tabulated per-antenna beams of one instrument
are nearly a low-rank family. The engine stacks the tables, takes their SVD
and keeps the smallest rank K whose measured per-beam L-infinity residual is
within ``tol`` (``eps / 8``), then runs the K-eigenbeam basis path with
per-antenna coefficients. Every later step that reads the tables is linear
in them, so the measured truncation residual is the only error.

The channel list is chosen by exactness: the k <= l half-list with transpose
reuse when the tables are real and the sky coherency symmetric, the full
ordered K^2 list otherwise.

Plans, and declines, are kept in :data:`AUTORANK_CACHE` under the tables'
content: a declined list is stored as a sentinel, so a call on a full-rank
list does not stack and decompose its tables again.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..beams.gridded import GriddedBeam
from ..beams.interface import BeamInterface
from .hashing import LRUCache, beam_fingerprint, hash_parts

logger = logging.getLogger(__name__)

AUTORANK_CACHE = LRUCache(8)
# A cached decline: LRUCache takes None for a miss.
_DECLINED = object()


@dataclass(frozen=True)
class AutoRankPlan:
    """A planned compression: K eigenbeams + per-input-beam coefficients."""

    eigenbeams: tuple  # K GriddedBeam efield eigenbeams (common grid)
    coefs: np.ndarray  # (nbeam, K); beam b  ~=  sum_k coefs[b, k] * eigen[k]
    kl_pairs: tuple  # channel list ((k, l), ...)
    kl_sym: bool  # True: k<=l half-list + transpose reuse (exact here)
    residual: float  # achieved max per-beam Linf relative residual
    tol: float  # requested residual budget

    @property
    def K(self) -> int:
        return len(self.eigenbeams)


def _common_gridded(beam_list):
    """The underlying GriddedBeams when every entry shares one efield grid."""
    gbs = []
    for b in beam_list:
        inner = b.beam if isinstance(b, BeamInterface) else b
        if not isinstance(inner, GriddedBeam) or inner.beam_type != "efield":
            return None
        gbs.append(inner)
    first = gbs[0]
    for g in gbs[1:]:
        if g.data_array.shape != first.data_array.shape:
            return None
        if not (
            np.array_equal(g.axis1_array, first.axis1_array)
            and np.array_equal(g.axis2_array, first.axis2_array)
            and np.array_equal(g.freq_array, first.freq_array)
        ):
            return None
        if (g.feeds or None) != (first.feeds or None):
            return None
    return gbs


def _choose_rank(U, s, Vh, stacked, tol):
    """Smallest K whose exact per-beam Linf relative residual is <= tol.

    The residual is measured, not bounded: ``max_b max|row_b - rec_b|``
    normalized by the global table peak. The SVD is L2-optimal, so the
    Linf residual need not be monotone in K: scan K upward with an
    incremental rank-1 reconstruction and take the first K that meets the
    budget. Returns (K, residual) with K = nbeam (residual 0) when even
    full rank is needed.
    """
    nbeam = stacked.shape[0]
    scale = np.abs(stacked).max()
    if scale == 0.0:
        return 1, 0.0
    rec = np.zeros_like(stacked)
    for K in range(1, nbeam + 1):
        rec += np.outer(U[:, K - 1] * s[K - 1], Vh[K - 1])
        r = float(np.abs(stacked - rec).max() / scale)
        if r <= tol:
            return K, r
    return nbeam, 0.0


def plan_auto_rank(
    beam_list,
    tol: float,
    npairs: int,
    allow_sym: bool,
    min_gain: float = 2.0,
) -> AutoRankPlan | None:
    """Plan rank compression of a per-antenna beam list, or decline.

    Parameters
    ----------
    beam_list
        The simulation's beams (BeamInterface-wrapped or raw); compression
        requires all of them to be efield GriddedBeams on one common grid.
    tol
        Residual budget: the max per-beam Linf relative reconstruction
        error the truncation may introduce (the engine passes ``eps / 8``).
    npairs
        Channel count of the uncompressed per-pair routing (unique beam
        pairs); compression engages only when it beats this by
        ``min_gain``.
    allow_sym
        Whether the sky coherency is symmetric (unpolarized / V=0), making
        the k<=l half-list with transpose reuse exact for real tables.
    min_gain
        Required channel-count ratio (old / new) to engage.
    """
    if len(beam_list) < 2:
        return None
    gbs = _common_gridded(beam_list)
    if gbs is None:
        return None

    key = hash_parts(("autorank-v1", tuple(beam_fingerprint(g) for g in gbs), float(tol),
                      bool(allow_sym)))
    plan = AUTORANK_CACHE.get_or_build(key, lambda: _plan_uncached(gbs, tol, allow_sym)
                                       or _DECLINED)
    if plan is _DECLINED:
        return None
    if len(plan.kl_pairs) * min_gain > npairs:
        logger.info(
            "auto-rank: declined (K=%d -> %d channels vs %d pairs; gain < %.1fx)",
            plan.K, len(plan.kl_pairs), npairs, min_gain,
        )
        return None
    return plan


def _plan_uncached(gbs, tol, allow_sym) -> AutoRankPlan | None:
    first = gbs[0]
    shape = first.data_array.shape
    stacked = np.stack([np.asarray(g.data_array).ravel() for g in gbs], axis=0)
    scale = np.abs(stacked).max()
    if not np.isfinite(scale) or scale == 0.0:
        return None

    # Real tables admit a real SVD (real coefficients + real eigenbeams),
    # which is what makes the symmetric half-list exact below.
    is_real = (np.max(np.abs(stacked.imag)) <= 1e-14 * scale
               if np.iscomplexobj(stacked) else True)
    work = stacked.real.astype(np.float64) if is_real else stacked.astype(np.complex128)

    try:
        U, s, Vh = np.linalg.svd(work, full_matrices=False)
    except np.linalg.LinAlgError:  # pragma: no cover - degenerate input
        return None

    K, residual = _choose_rank(U, s, Vh, work, tol)
    if K >= len(gbs):
        return None

    coefs = (U[:, :K] * s[:K]).astype(np.float64 if is_real else np.complex128)

    eigenbeams = []
    for k in range(K):
        data = Vh[k].reshape(shape)
        if not is_real:
            data = np.ascontiguousarray(data)
        eigenbeams.append(GriddedBeam(data, first.axis1_array, first.axis2_array,
                                      first.freq_array, beam_type="efield", feeds=first.feeds))

    # Channel list. The k<=l half-list + transpose reuse assumes
    # rows_(l,k) = rows_(k,l)^T over the feed axes, i.e. A_l^H C A_k =
    # (A_k^H C A_l)^T -- exact iff the tables are real AND the sky
    # coherency C is symmetric (V=0). Otherwise run the full ordered K^2
    # list: each channel is contracted with its own coefficient product,
    # exact for any complex tables and any Hermitian C.
    kl_sym = bool(allow_sym and is_real)
    if kl_sym:
        kl_pairs = tuple((k, l) for k in range(K) for l in range(k, K))
    else:
        kl_pairs = tuple((k, l) for k in range(K) for l in range(K))

    logger.info(
        "auto-rank: %d beams -> K=%d eigenbeams (%s channel list, residual %.2e <= %.2e)",
        len(gbs), K, "symmetric" if kl_sym else "ordered", residual, tol,
    )
    return AutoRankPlan(eigenbeams=tuple(eigenbeams), coefs=coefs, kl_pairs=kl_pairs,
                        kl_sym=kl_sym, residual=residual, tol=float(tol))
