"""Host-side transform planning for the CUDA engine.

The port of the coplanar branch of ``plan_transform``
(``fftvis_tpu/tpu/planning.py``): choose the exact direct path or the
type-3 NUFFT from a cost model and build the type-3 plan. The spread term
is the scatter cost ``16 * nsrc * w^2`` -- the card's spreader, like a
scatter, does O(w^2) work per source; the TPU matrix-unit spread terms do
not apply.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..core import utils as core_utils
from ..core.antenna_gridding import check_antpos_griddability
from ..core.utils import speed_of_light
from ..nufft.transform import Type3Executor, fit_plan_precorr, plan_type3

logger = logging.getLogger(__name__)

TWO_PI = 2.0 * np.pi


@dataclass
class SimPlan:
    """Host-side configuration of one simulation's transform."""

    mode: str  # 'type3' | 'direct'
    executor: Type3Executor | None
    targets: np.ndarray | None  # direct mode: (2, nbl) signed targets, meters
    rotation_matrix: np.ndarray  # (3, 3) applied to topo for NUFFT coords


def plan_transform(
    nufft_mode: str,
    ants: dict,
    baselines,
    freqs,
    eps: float,
    upsample_factor: float,
    flat_array_tol: float,
    force_use_type3: bool,
    flipped_global: np.ndarray,
    nbl: int,
    nsrc: int,
    nfeeds: int,
    npairs: int,
    device,
) -> SimPlan:
    """Choose the transform path and build its plan (host).

    Gridded arrays take the exact type-1 path in the JAX package, which is
    not ported yet: unless type-3 is forced (``force_use_type3`` or
    ``nufft_mode`` 'type3') or the direct path is asked for, they raise.
    """
    if nufft_mode == "type1":
        raise NotImplementedError("the type-1 transform is ROADMAP item 4")
    antvecs = np.array([np.asarray(ants[a], dtype=float) for a in ants])
    fmax = float(np.max(freqs))

    if (
        np.abs(antvecs[:, -1]).max() <= flat_array_tol
        and not force_use_type3
        and nufft_mode == "auto"
        and check_antpos_griddability(ants)[0]
    ):
        raise NotImplementedError(
            "gridded array: its type-1 path is ROADMAP item 4; pass "
            "force_use_type3=True or nufft_mode='direct'"
        )

    # Rotate a tilted plane into XY.
    rotation = core_utils.get_plane_to_xy_rotation_matrix(antvecs).T
    rot_ants = (rotation @ antvecs.T).T
    pos = {a: rot_ants[i] for i, a in enumerate(ants)}
    blvec = np.array([pos[bj] - pos[bi] for bi, bj in baselines]).T  # (3, nbl)
    if not np.all(np.abs(blvec[2]) <= flat_array_tol):
        raise NotImplementedError(
            "non-coplanar (3D) arrays are ROADMAP item 8"
        )
    targets = np.where(flipped_global[None, :], -blvec[:2], blvec[:2])

    # Cost model: exact direct vs spread + FFT + interp.
    direct_cost = 8.0 * nsrc * nbl
    x_ext = [TWO_PI * fmax / speed_of_light] * 2
    # fit_precorr deferred: the chebfit host time is only paid if the
    # type-3 path wins the comparison.
    probe = plan_type3(
        targets, x_extent=x_ext, eps=eps,
        upsample_factor=upsample_factor, fit_precorr=False,
    )
    w = probe.kernel.w
    C = max(1, npairs * nfeeds**2)
    nf_cells = float(np.prod(probe.nf))
    nufft_cost = (
        16.0 * nsrc * w**2
        + 5.0 * nf_cells * np.log2(max(nf_cells, 2)) / C
        + 16.0 * nbl * w**2
    )
    if nufft_mode == "direct" or (
        nufft_mode == "auto" and direct_cost < nufft_cost
    ):
        logger.info(
            "Using exact direct path (cost %.2e < nufft %.2e)",
            direct_cost, nufft_cost,
        )
        return SimPlan("direct", None, targets, rotation)

    logger.info("Using type-3 NUFFT path (nf=%s, w=%d)", probe.nf, w)
    executor = Type3Executor(fit_plan_precorr(probe), device=device)
    return SimPlan("type3", executor, None, rotation)
