"""Host-side transform planning for the CUDA engine.

The port of ``plan_transform`` and ``select_gridded_path``
(``fftvis_tpu/tpu/planning.py``) for coplanar arrays:

- a gridded array (antennas on an integer lattice) takes the exact type-1
  transform at the baselines' integer lattice modes, or the direct path
  when it is asked for;
- any other coplanar array takes the exact direct path or the type-3
  NUFFT, from a cost model whose spread term is the scatter cost ``16 *
  nsrc * w^2`` -- the card's spreader, like a scatter, does O(w^2) work per
  source; the TPU matrix-unit spread terms do not apply.

The JAX package's ES type-1 (``Type1Executor``) is not ported: where the
exact transform does not apply, or ``FFTVIS_TYPE1=es`` asks for ES, the
planner raises ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np

from ..core import utils as core_utils
from ..core.antenna_gridding import check_antpos_griddability
from ..core.utils import speed_of_light
from ..nufft.transform import Type3Executor, fit_plan_precorr, plan_type3
from ..nufft.type1 import Type1ExactExecutor, plan_type1_exact

logger = logging.getLogger(__name__)

TWO_PI = 2.0 * np.pi
# Largest exact type-1 mode grid (cells), the JAX package's dense-spread
# size class.
DENSE_GRID_LIMIT = 512 * 512


@dataclass(frozen=True)
class SimPlan:
    """Host-side configuration of one simulation's transform. The engine
    keeps it across calls, so nothing sets its fields; its executor keeps
    device tables that every call on its configuration shares."""

    mode: str  # 'type1' | 'type3' | 'direct'
    executor: Type3Executor | Type1ExactExecutor | None
    # direct mode: (2, nbl) signed targets, meters (or lattice modes)
    targets: np.ndarray | None
    rotation_matrix: np.ndarray  # (3, 3) applied to topo for NUFFT coords
    # gridded arrays: (3, 3) topo -> lattice coordinates over c, (basis / c).T
    lattice_matrix: np.ndarray | None = None

    @property
    def coord_matrix(self) -> np.ndarray:
        """(2, 3): topocentric source vectors -> the array-plane position
        (meters) or, on a lattice, the lattice coordinates over c."""
        m = self.rotation_matrix if self.lattice_matrix is None else self.lattice_matrix
        return m[:2]

    def coord_scale(self, freq: float) -> float:
        """What takes :attr:`coord_matrix` coordinates to the transform's
        source coordinates at ``freq``: 2 pi nu / c, or 2 pi nu on a
        lattice."""
        if self.lattice_matrix is not None:
            return TWO_PI * freq
        return TWO_PI * freq / speed_of_light


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

    A gridded array (unless type-3 is forced by ``force_use_type3`` or
    ``nufft_mode`` 'type3') goes to :func:`select_gridded_path`; targets of
    flipped baselines take the negated sign, as the pair routing stores
    them reversed.
    """
    antvecs = np.array([np.asarray(ants[a], dtype=float) for a in ants])
    fmax = float(np.max(freqs))

    is_gridded = False
    if (
        np.abs(antvecs[:, -1]).max() <= flat_array_tol
        and not force_use_type3
        and nufft_mode != "type3"
    ):
        is_gridded, gridded_pos, basis = check_antpos_griddability(ants)

    if is_gridded:
        bls_int = np.array(
            [gridded_pos[bj] - gridded_pos[bi] for bi, bj in baselines]
        ).T[:2]
        bls_int = np.round(bls_int).astype(np.int64)
        bls_signed = np.where(flipped_global[None, :], -bls_int, bls_int)
        # Source lattice coordinates are (basis / c)^T topo.
        lattice = (basis / speed_of_light).T
        mode, executor, targets = select_gridded_path(nufft_mode, bls_signed, device)
        logger.info("Gridded array detected: using the %s path", mode)
        return SimPlan(mode, executor, targets, np.eye(3), lattice)

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


def select_gridded_path(nufft_mode: str, bls_signed: np.ndarray, device):
    """Gridded arrays: the exact type-1 transform, or the direct path when
    ``nufft_mode`` is 'direct'. Returns (mode, executor, direct targets).

    The exact transform applies while its mode grid holds at most
    :data:`DENSE_GRID_LIMIT` cells and its factor phases stay exact in
    float32 (kmax * nm < 2^23 an axis). Beyond its reach, and under
    ``FFTVIS_TYPE1=es``, the JAX package runs ES type-1, which the port does
    not have yet: that raises.
    """
    if nufft_mode == "direct":
        return "direct", None, bls_signed.astype(float)
    t1_env = os.environ.get("FFTVIS_TYPE1", "auto")
    if t1_env not in ("auto", "es"):
        raise ValueError(f"FFTVIS_TYPE1={t1_env!r}: expected 'auto' or 'es'")
    xplan = plan_type1_exact(bls_signed)
    f32_safe = all(k * n < 2**23 for k, n in zip(xplan.kmax, xplan.nf))
    if t1_env == "auto" and f32_safe and int(np.prod(xplan.nf)) <= DENSE_GRID_LIMIT:
        logger.info("Gridded path: exact separable DFT (mode grid %s)", xplan.nf)
        return "type1", Type1ExactExecutor(xplan, device=device), None
    raise NotImplementedError(
        f"ES type-1 (Type1Executor) is ROADMAP item 4: the exact type-1 "
        f"transform does not take this lattice (mode grid {xplan.nf}, "
        f"FFTVIS_TYPE1={t1_env}); pass force_use_type3=True or "
        f"nufft_mode='direct'"
    )
