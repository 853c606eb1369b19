"""Beam-pair routing of baselines (host NumPy).

A NumPy copy of ``plan_beam_pairs`` from ``fftvis_tpu/core/beams.py``: the
beam-pair -> baseline routing with conjugate-flip bookkeeping. The slice
runs a single shared beam, so every baseline maps to pair (0, 0) unflipped;
the routing stays so that the engine's flip convention has one source.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BeamPairPlan:
    """Static routing of baselines onto unique beam pairs.

    Attributes
    ----------
    pairs
        Unique (beam_i, beam_j) index pairs with i-group <= j-group.
    bls_idxs
        For each pair, the indices of the baselines it covers.
    flipped
        For each pair, a boolean array marking baselines stored as the
        reversed (j, i) orientation: their uvw is negated and the resulting
        visibility conjugated (ref cpu_simulate.py:259-298).
    """

    pairs: tuple
    bls_idxs: tuple
    flipped: tuple

    @property
    def npairs(self) -> int:
        return len(self.pairs)


def plan_beam_pairs(antnums, baselines, beam_idx) -> BeamPairPlan:
    """Group baselines by unique (beam_i, beam_j) pair with flip bookkeeping.

    Matches the reference's routing semantics (ref cpu/beams.py:91-127):
    with a single shared beam everything maps to pair (0, 0) unflipped.
    """
    nbl = len(baselines)
    if beam_idx is None:
        return BeamPairPlan(
            pairs=((0, 0),),
            bls_idxs=(np.arange(nbl),),
            flipped=(np.zeros(nbl, dtype=bool),),
        )

    beam_idx = np.asarray(beam_idx)
    ant_to_beam = {a: int(b) for a, b in zip(antnums, beam_idx)}
    unique = np.unique(beam_idx)
    pair_list = [
        (int(unique[i]), int(unique[j]))
        for i in range(len(unique))
        for j in range(i, len(unique))
    ]
    pair_set = set(pair_list)

    idxs: dict = {p: [] for p in pair_list}
    flips: dict = {p: [] for p in pair_list}
    for k, (ai, aj) in enumerate(baselines):
        bi, bj = ant_to_beam[ai], ant_to_beam[aj]
        if (bi, bj) in pair_set:
            key, flip = (bi, bj), False
        elif (bj, bi) in pair_set:
            key, flip = (bj, bi), True
        else:  # pragma: no cover - unique pairs cover all combinations
            raise ValueError("Beam pair not in beam pair list")
        idxs[key].append(k)
        flips[key].append(flip)

    pairs, bidx, flipped = [], [], []
    for p in pair_list:
        if idxs[p]:
            pairs.append(p)
            bidx.append(np.asarray(idxs[p], dtype=np.int64))
            flipped.append(np.asarray(flips[p], dtype=bool))
    return BeamPairPlan(pairs=tuple(pairs), bls_idxs=tuple(bidx), flipped=tuple(flipped))
