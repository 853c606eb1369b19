"""Host-side transform planning for the CUDA engine.

The port of ``plan_transform`` and ``select_gridded_path``
(``fftvis_tpu/tpu/planning.py``):

- a gridded array (antennas on an integer lattice) takes the exact type-1
  transform at the baselines' integer lattice modes, or, past its reach or
  under ``FFTVIS_TYPE1=es``, the ES type-1 NUFFT
  (:class:`~fftvis_tpu_torch.nufft.transform.Type1Executor`), or the
  direct path when it is asked for;
- any other array takes the exact direct path or the type-3 NUFFT, from a
  cost model whose spread term is the scatter cost ``16 * nsrc * w^2`` --
  the card's spreader, like a scatter, does O(w^2) work per source; the
  TPU matrix-unit spread terms do not apply;
- a non-coplanar (3D) array's type-3 is the low-rank z factorization
  (:class:`~fftvis_tpu_torch.nufft.transform.Type3LowrankZExecutor`): its
  K Chebyshev z modes multiply the spread, FFT and interpolation terms of
  the cost model, and an array too tall for the expansion takes the direct
  path.

``FFTVIS_TYPE1=exact`` forces the exact transform and ``es`` the ES one,
as in the JAX package; the JAX planner's TPU-only crossover to ES at small
channel counts does not apply on the card.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np

from ..core import utils as core_utils
from ..core.antenna_gridding import check_antpos_griddability
from ..core.utils import speed_of_light
from ..nufft.transform import (
    Type1Executor,
    Type3Executor,
    Type3LowrankZExecutor,
    fit_plan_precorr,
    plan_type1,
    plan_type3,
    plan_type3_lowrank_z,
)
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
    executor: (Type3Executor | Type3LowrankZExecutor | Type1ExactExecutor | Type1Executor
               | None)
    # direct mode: (d, nbl) signed targets, meters (or lattice modes)
    targets: np.ndarray | None
    rotation_matrix: np.ndarray  # (3, 3) applied to topo for NUFFT coords
    # gridded arrays: (3, 3) topo -> lattice coordinates over c, (basis / c).T
    lattice_matrix: np.ndarray | None = None
    # False for a non-coplanar array: d = 3 source coordinates and targets.
    is_coplanar: bool = True

    @property
    def coord_matrix(self) -> np.ndarray:
        """(d, 3): topocentric source vectors -> the array-plane position
        (meters; with the height off the plane on a non-coplanar array, d =
        3) or, on a lattice, the lattice coordinates over c (d = 2)."""
        if self.lattice_matrix is not None:
            return self.lattice_matrix[:2]
        return self.rotation_matrix[: 2 if self.is_coplanar else 3]

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
        mode, executor, targets = select_gridded_path(nufft_mode, bls_signed, eps,
                                                      upsample_factor, device)
        logger.info("Gridded array detected: using the %s path", mode)
        return SimPlan(mode, executor, targets, np.eye(3), lattice)

    # Rotate a tilted plane into XY.
    rotation = core_utils.get_plane_to_xy_rotation_matrix(antvecs).T
    rot_ants = (rotation @ antvecs.T).T
    pos = {a: rot_ants[i] for i, a in enumerate(ants)}
    blvec = np.array([pos[bj] - pos[bi] for bi, bj in baselines]).T  # (3, nbl)
    is_coplanar = bool(np.all(np.abs(blvec[2]) <= flat_array_tol))
    d = 2 if is_coplanar else 3
    targets = np.where(flipped_global[None, :], -blvec[:d], blvec[:d])

    # Cost model: exact direct vs spread + FFT + interp.
    direct_cost = 8.0 * nsrc * nbl
    x_ext = [TWO_PI * fmax / speed_of_light] * d
    if d == 2:
        # fit_precorr deferred: the chebfit host time is only paid if the
        # type-3 path wins the comparison.
        probe = plan_type3(
            targets, x_extent=x_ext, eps=eps,
            upsample_factor=upsample_factor, fit_precorr=False,
        )
        K = 1
    else:
        # The low-rank z factorization: K Chebyshev z modes batched through
        # the 2D spread, its bandwidth bounded by the z range of the rotated
        # upper-hemisphere source vectors.
        zlo, zhi = upper_hemisphere_z_range(rotation[2])
        scale = TWO_PI * fmax / speed_of_light
        pad = 1e-3  # aberration + float slop before the executor's clamp
        try:
            probe_z = plan_type3_lowrank_z(
                targets, x_extent=x_ext, eps=eps, upsample_factor=upsample_factor,
                x_range_z=((zlo - pad) * scale, (zhi + pad) * scale), fit_precorr=False,
            )
        except ValueError as err:
            # z bandwidth beyond the expansion's reach (very tall arrays):
            # the exact direct path is the only accurate option.
            logger.warning(
                "3D type-3 low-rank factorization unavailable (%s); "
                "using the exact direct path", err,
            )
            return SimPlan("direct", None, targets, rotation, is_coplanar=False)
        probe = probe_z.plan2d
        K = probe_z.K
    w = probe.kernel.w
    C = max(1, npairs * nfeeds**2)
    nf_cells = float(np.prod(probe.nf))
    nufft_cost = (
        K * (16.0 * nsrc * w**2)
        + 5.0 * K * nf_cells * np.log2(max(nf_cells, 2)) / C
        + 16.0 * nbl * w**2 * K
    )
    if nufft_mode == "direct" or (
        nufft_mode == "auto" and direct_cost < nufft_cost
    ):
        logger.info(
            "Using exact direct path (cost %.2e < nufft %.2e)",
            direct_cost, nufft_cost,
        )
        return SimPlan("direct", None, targets, rotation, is_coplanar=is_coplanar)

    if d == 3:
        logger.info("Using type-3 NUFFT path (3D lowrank-z: nf=%s, w=%d, K=%d)",
                    probe.nf, w, K)
        executor = Type3LowrankZExecutor(fit_plan_precorr(probe_z), device=device)
    else:
        logger.info("Using type-3 NUFFT path (nf=%s, w=%d)", probe.nf, w)
        executor = Type3Executor(fit_plan_precorr(probe), device=device)
    return SimPlan("type3", executor, None, rotation, is_coplanar=is_coplanar)


def upper_hemisphere_z_range(r: np.ndarray) -> tuple[float, float]:
    """(lo, hi) of ``r . v`` over the upper hemisphere, |v| = 1 and v_z >=
    0: the maximum is 1 when ``r`` points up (else on the horizon circle,
    |r_xy|), the minimum -1 when it points down (else -|r_xy|). ``r`` is a
    unit row of the plane rotation."""
    rxy = float(np.hypot(r[0], r[1]))
    zhi = 1.0 if r[2] >= 0 else rxy
    zlo = -1.0 if r[2] <= 0 else -rxy
    return zlo, zhi


def select_gridded_path(nufft_mode: str, bls_signed: np.ndarray, eps: float,
                        upsample_factor: float, device):
    """Gridded arrays: the exact type-1 transform, ES type-1, or the direct
    path when ``nufft_mode`` is 'direct'. Returns (mode, executor, direct
    targets).

    The exact transform is taken under ``FFTVIS_TYPE1=exact``, and in
    ``auto`` mode while its mode grid holds at most
    :data:`DENSE_GRID_LIMIT` cells and its factor phases stay exact in
    float32 (kmax * nm < 2^23 an axis); forced past the float32 check it
    warns, as the JAX planner does. Otherwise, and always under
    ``FFTVIS_TYPE1=es``, the ES type-1 at the requested ``eps`` and
    ``upsample_factor`` (sigma stays as asked: the JAX package measured
    sigma = 1.25 breaking its float32 gridded accuracy).
    """
    if nufft_mode == "direct":
        return "direct", None, bls_signed.astype(float)
    t1_env = os.environ.get("FFTVIS_TYPE1", "auto")
    if t1_env not in ("auto", "exact", "es"):
        raise ValueError(f"FFTVIS_TYPE1={t1_env!r}: expected 'auto', 'exact' or 'es'")
    xplan = plan_type1_exact(bls_signed)
    f32_safe = all(k * n < 2**23 for k, n in zip(xplan.kmax, xplan.nf))
    if t1_env == "exact" and not f32_safe:
        logger.warning(
            "FFTVIS_TYPE1=exact forced on a lattice whose factor phases "
            "exceed the f32-exact bound (kmax*nm >= 2^23 on some axis, mode "
            "grid %s); expect degraded accuracy in float32.", xplan.nf,
        )
    if t1_env == "exact" or (
        t1_env == "auto" and f32_safe and int(np.prod(xplan.nf)) <= DENSE_GRID_LIMIT
    ):
        logger.info("Gridded path: exact separable DFT (mode grid %s)", xplan.nf)
        return "type1", Type1ExactExecutor(xplan, device=device), None
    plan = plan_type1(bls_signed, eps, upsample_factor)
    logger.info("Gridded path: ES type-1 (fine grid %s, w=%d; exact mode grid %s)",
                plan.nf, plan.kernel.w, xplan.nf)
    return "type1", Type1Executor(plan, device=device), None
