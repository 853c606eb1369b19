"""The NUFFT transforms: host planning (NumPy) + device execution (torch).

The port of ``fftvis_tpu/nufft/transform.py``, with the +i sign convention
of finufft's defaults, f(s) = sum_j c_j exp(+i s . x_j):

- type-1 (:class:`Type1Executor`): ES-spread onto the periodic fine grid
  -> batched (i)FFT -> gather at the requested integer modes with their
  deconvolution. The engine takes it for a gridded array past the exact
  type-1 path's reach, or under ``FFTVIS_TYPE1=es``;
- type-2 (:class:`Type2Executor`), its transpose: scatter-add of the
  deconvolved modes -> FFT -> ES interpolation at the planned points;
- type-3 (:class:`Type3Executor`): pre-phase + pre-correction -> ES-spread
  -> batched FFT -> grid deconvolution -> ES interpolation at the
  nonuniform targets; and in 3D through the low-rank z factorization
  (non-coplanar arrays, :class:`Type3LowrankZExecutor`: K Chebyshev z
  modes ride the 2D spread and interpolation as C*K channels, then a
  contraction with host-planned target coefficients).

Planning (:func:`plan_type1`, :func:`plan_type2`, :func:`plan_type3`,
:func:`plan_type3_lowrank_z`, :func:`fit_plan_precorr`) is a NumPy copy and
gives exactly the JAX package's plan arrays. Execution runs on the
executor's torch device, at d = 1, 2 or 3 (the engine's transforms are 2D;
the public ``make_type{1,2,3}_fn`` take any of the three): the spread and
interpolation go through the hand-written CUDA kernels of :mod:`.spread`
and :mod:`.interp` on a CUDA tensor and through their plain torch versions
on a CPU tensor; the FFT is ``torch.fft`` (cuFFT on the card) and the
type-2 scatter of the modes is ``index_add_`` (the JAX package's is an XLA
scatter, not a Pallas kernel).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .interp import (bin_order_3d, footprint_runs, interp_nd, interp_pairs, target_order,
                     tile_tensors)
from .kernels import (
    ESKernel,
    es_kernel_ft,
    es_kernel_ft_cheb,
    es_kernel_grid,
    fit_log_ft_cheb,
    next_fast_size,
)
from .direct import phasor
from .spread import spread_nd


def _check_int32_grid(nf) -> None:
    """Guard the int32 index space of the device tap tables."""
    cells = int(np.prod([int(n) for n in nf]))
    if cells > np.iinfo(np.int32).max:
        raise ValueError(
            f"planned grid has {cells} cells, exceeding the int32 index "
            "space used for device gather/scatter indices; reduce the mode "
            "extent or split the transform"
        )


@dataclass(frozen=True)
class Type1Plan:
    """Plan for a d-dimensional type-1 transform gathered at fixed modes.

    The deconvolution and gather are planned per requested mode, so the
    full deconvolved grid is never formed.
    """

    kernel: ESKernel
    d: int
    nf: tuple[int, ...]
    # Per-target gather positions in FFT-order flat indexing, (m,) int32.
    gather_idx: np.ndarray
    # Per-target deconvolution factors, (m,) float64.
    gather_deconv: np.ndarray
    n_targets: int

    @classmethod
    def from_reference(cls, plan) -> "Type1Plan":
        """Build the port's plan from a ``fftvis_tpu`` ``Type1Plan``, its
        fields read by attribute as NumPy arrays (frozen), so both
        packages' executors can run one plan."""
        k = plan.kernel
        idx = np.array(plan.gather_idx)
        dec = np.array(plan.gather_deconv)
        idx.setflags(write=False)
        dec.setflags(write=False)
        return cls(
            kernel=ESKernel(w=int(k.w), beta=float(k.beta),
                            sigma=float(k.sigma), eps=float(k.eps)),
            d=int(plan.d),
            nf=tuple(int(n) for n in plan.nf),
            gather_idx=idx,
            gather_deconv=dec,
            n_targets=int(plan.n_targets),
        )


@dataclass(frozen=True)
class Type3Plan:
    """Plan for a d-dimensional type-3 transform at fixed targets."""

    kernel: ESKernel
    d: int
    nf: tuple[int, ...]
    h: tuple[float, ...]  # stage-A grid spacing per dim (x units)
    ds: tuple[float, ...]  # uniform s-sample spacing per dim
    s_center: tuple[float, ...]
    # Per-dim mode deconvolution vectors in FFT order, each (nf_d,) float64.
    deconv: tuple[np.ndarray, ...]
    # Per-dim interpolation taps: indices (m, w) int32, w consecutive cells
    # from the first (mod nf applied), and kernel values (m, w) float64.
    tap_idx: tuple[np.ndarray, ...]
    tap_val: tuple[np.ndarray, ...]
    n_targets: int
    # Host-fitted log-Chebyshev of psi_hat over the planned extent (per
    # dim); float32 executors evaluate the amplitude pre-correction from
    # it. None entries use the quadrature.
    ft_coefs: tuple = ()
    ft_xi_max: tuple = ()

    @classmethod
    def from_reference(cls, plan) -> "Type3Plan":
        """Build the port's plan from a ``fftvis_tpu`` ``Type3Plan``.

        Reads the reference plan's fields by attribute, as NumPy arrays, so
        both packages' executors can run one plan. The executor puts the
        tables on its device.
        """
        k = plan.kernel
        return cls(
            kernel=ESKernel(w=int(k.w), beta=float(k.beta),
                            sigma=float(k.sigma), eps=float(k.eps)),
            d=int(plan.d),
            nf=tuple(int(n) for n in plan.nf),
            h=tuple(float(v) for v in plan.h),
            ds=tuple(float(v) for v in plan.ds),
            s_center=tuple(float(v) for v in plan.s_center),
            deconv=tuple(np.asarray(a) for a in plan.deconv),
            tap_idx=tuple(np.asarray(a) for a in plan.tap_idx),
            tap_val=tuple(np.asarray(a) for a in plan.tap_val),
            n_targets=int(plan.n_targets),
            ft_coefs=tuple(
                None if c is None else np.asarray(c) for c in plan.ft_coefs
            ),
            ft_xi_max=tuple(float(v) for v in plan.ft_xi_max),
        )


def plan_type1(
    modes: np.ndarray,
    eps: float,
    upsample_factor: float = 2.0,
    prefer_pow2: bool = False,
) -> Type1Plan:
    """Plan a type-1 transform gathered at integer ``modes``.

    Parameters
    ----------
    modes
        Integer mode indices, shape (d, m). May be negative (FFT wrap).
    eps
        Requested accuracy (same semantics as finufft / the reference API).
    upsample_factor
        Fine-grid oversampling sigma, 1.25 or 2.
    """
    modes = np.atleast_2d(np.asarray(modes, dtype=np.int64))
    d, m = modes.shape
    kernel = ESKernel.from_eps(eps, upsample_factor)

    # The fine grid must hold the requested modes inside the accurate band
    # |k| <= nf / (2 sigma).
    kmax = np.max(np.abs(modes), axis=1)  # (d,)
    nf = tuple(
        next_fast_size(
            int(np.ceil(2 * upsample_factor * max(km, 1) + kernel.w)),
            prefer_pow2=prefer_pow2,
        )
        for km in kmax
    )

    # FFT-order flat gather index and per-target deconvolution. The kernel
    # FT is evaluated once per unique |k| per axis.
    _check_int32_grid(nf)
    flat = np.zeros(m, dtype=np.int64)
    deconv = np.ones(m, dtype=np.float64)
    for axis in range(d):
        k = modes[axis]
        idx = np.mod(k, nf[axis])
        flat = flat * nf[axis] + idx
        km = int(kmax[axis])
        table = es_kernel_ft(
            2.0 * np.pi * np.arange(km + 1) / nf[axis], kernel.w, kernel.beta
        )
        deconv /= table[np.abs(k)]
    gather_idx = flat.astype(np.int32)
    # Frozen: cache keys fingerprint these (core/hashing.py).
    gather_idx.setflags(write=False)
    deconv.setflags(write=False)
    return Type1Plan(
        kernel=kernel,
        d=d,
        nf=nf,
        gather_idx=gather_idx,
        gather_deconv=deconv,
        n_targets=m,
    )


@dataclass(frozen=True)
class Type3LowrankZPlan:
    """Plan for a 3D type-3 transform as K z-modes of a batched 2D type-3.

    The z phase factor is factored at low rank,

        exp(i s_z x_z) = exp(i s_zc x_z)                 [device pre-phase]
                       * exp(i s'_z x_c)                 [folded into g]
                       * sum_k a_k(s'_z zh) T_k(t),      t = (x_z - x_c)/zh

    a Chebyshev (Jacobi-Anger) expansion whose length K ~ |s'|_max zh +
    O(log 1/eps) is small for near-coplanar arrays: each z-mode multiplies
    the weights by T_k(t), giving a 2D type-3 with C*K channels on the 2D
    fine grid. The target-side coefficients g (m, K) come from a
    Chebyshev-node DCT on the host.
    """

    plan2d: Type3Plan
    K: int
    s_center_z: float
    x_center_z: float
    x_half_z: float
    # (m, K) complex128: a_k(s'_m zh) * exp(i s'_m x_c).
    g: np.ndarray
    n_targets: int

    @classmethod
    def from_reference(cls, zplan) -> "Type3LowrankZPlan":
        """Build the port's plan from a ``fftvis_tpu``
        ``Type3LowrankZPlan``, its 2D plan through
        :meth:`Type3Plan.from_reference`, so both packages' executors can
        run one plan."""
        return cls(
            plan2d=Type3Plan.from_reference(zplan.plan2d),
            K=int(zplan.K),
            s_center_z=float(zplan.s_center_z),
            x_center_z=float(zplan.x_center_z),
            x_half_z=float(zplan.x_half_z),
            g=np.asarray(zplan.g),
            n_targets=int(zplan.n_targets),
        )


def plan_type3_lowrank_z(
    targets: np.ndarray,
    x_extent,
    eps: float,
    upsample_factor: float = 2.0,
    prefer_pow2: bool = False,
    x_range_z: tuple[float, float] | None = None,
    max_modes: int = 160,
    fit_precorr: bool = True,
) -> Type3LowrankZPlan:
    """Plan a 3D type-3 transform via the low-rank z factorization.

    Parameters match :func:`plan_type3` (d must be 3); ``x_range_z``
    optionally tightens the source z-coordinate range to (lo, hi) -- e.g.
    (0, X) for topocentric up-hemisphere sources -- which halves the
    Chebyshev bandwidth versus the symmetric default (-X, X). Raises
    ``ValueError`` when the expansion would need more than ``max_modes``
    modes (the planner then takes the direct path).
    """
    targets = np.atleast_2d(np.asarray(targets, dtype=np.float64))
    d, m = targets.shape
    if d != 3:
        raise ValueError(f"lowrank-z planning requires d=3, got {d}")
    x_extent = np.broadcast_to(np.asarray(x_extent, dtype=np.float64), (3,))

    plan2d = plan_type3(
        targets[:2], x_extent[:2], eps, upsample_factor, prefer_pow2,
        fit_precorr=fit_precorr,
    )

    sz = targets[2]
    s_zc = 0.5 * (float(sz.min()) + float(sz.max()))
    s_prime = sz - s_zc

    if x_range_z is None:
        zlo, zhi = -float(x_extent[2]), float(x_extent[2])
    else:
        zlo, zhi = float(x_range_z[0]), float(x_range_z[1])
    x_c = 0.5 * (zlo + zhi)
    zh = max(0.5 * (zhi - zlo), 1e-12)

    lam = s_prime * zh  # per-target Chebyshev bandwidth
    lam_max = float(np.max(np.abs(lam))) if m else 0.0

    # Chebyshev coefficients of exp(i lam t) on t in [-1, 1] via a DCT at
    # Chebyshev-Gauss nodes. Upper bound on the needed degree: lam + a
    # superexponential-decay tail (|J_k(lam)| ~ (e lam / 2k)^k for k > lam).
    K_need = int(np.ceil(lam_max + 10.0 * np.log10(1.0 / eps) + 12))
    if K_need > max_modes:
        # The expansion has not started its superexponential decay before
        # the cap: truncation error would be O(1), not O(eps).
        raise ValueError(
            f"lowrank-z expansion needs ~{K_need} Chebyshev modes "
            f"(z bandwidth lam_max={lam_max:.1f}, eps={eps:.0e}) but "
            f"max_modes={max_modes}: the array's z extent is too large for "
            f"the low-rank factorization; use the direct path or raise "
            f"max_modes"
        )
    K_hi = max(K_need, 4)
    Q = 2 * K_hi
    theta = np.pi * (np.arange(Q) + 0.5) / Q
    tq = np.cos(theta)  # (Q,)
    # h[m, q] = exp(i lam_m t_q); a[m, k] = (2/Q) sum_q h cos(k theta_q).
    h = np.exp(1j * lam[:, None] * tq[None, :])  # (m, Q)
    cosmat = np.cos(np.outer(np.arange(K_hi), theta))  # (K_hi, Q)
    a = (2.0 / Q) * (h @ cosmat.T)  # (m, K_hi)
    a[:, 0] *= 0.5

    # Truncate where every target's tail is below eps (coefficients decay
    # superexponentially past lam, so this cutoff is sharp).
    amax = np.max(np.abs(a), axis=0)
    keep = np.nonzero(amax > 0.1 * eps)[0]
    K = int(keep[-1]) + 1 if keep.size else 1
    K = max(K, 1)

    g = a[:, :K] * np.exp(1j * s_prime * x_c)[:, None]
    g.setflags(write=False)
    return Type3LowrankZPlan(
        plan2d=plan2d,
        K=K,
        s_center_z=float(s_zc),
        x_center_z=float(x_c),
        x_half_z=float(zh),
        g=g,
        n_targets=m,
    )


def plan_type3(
    targets: np.ndarray,
    x_extent,
    eps: float,
    upsample_factor: float = 2.0,
    prefer_pow2: bool = False,
    fit_precorr: bool = True,
) -> Type3Plan:
    """Plan a type-3 transform onto fixed nonuniform ``targets``.

    Parameters
    ----------
    targets
        Target frequencies s, shape (d, m) (host data; e.g. 2 pi * uvw).
    x_extent
        Per-dim bound X_d with |x_d| <= X_d for all source coordinates.
    eps, upsample_factor
        Accuracy / oversampling, as in the reference API.
    fit_precorr
        Fit the log-Chebyshev amplitude pre-correction. Cost-model probe
        plans pass False and :func:`fit_plan_precorr` fills it in later.
    """
    targets = np.atleast_2d(np.asarray(targets, dtype=np.float64))
    d, m = targets.shape
    x_extent = np.broadcast_to(np.asarray(x_extent, dtype=np.float64), (d,))
    kernel = ESKernel.from_eps(eps, upsample_factor)
    sigma, w = upsample_factor, kernel.w

    s_lo = targets.min(axis=1)
    s_hi = targets.max(axis=1)
    s_center = 0.5 * (s_lo + s_hi)
    s_half = 0.5 * (s_hi - s_lo)

    nf, h, ds, deconv, tap_idx, tap_val = [], [], [], [], [], []
    ft_coefs, ft_xi_max = [], []
    for axis in range(d):
        X = max(float(x_extent[axis]), 1e-12)
        S = max(float(s_half[axis]), 1.0 / X)
        h_d = np.pi / (sigma * S)
        # Grid size: sigma-oversampled in BOTH domains (the type-3 sigma^2
        # law; finufft paper sec. 4), plus kernel margins. The second bound
        # keeps the interpolation taps inside the FFT band.
        nf_d = next_fast_size(
            max(
                int(np.ceil(2.0 * sigma**2 * X * S / np.pi + 2 * w + 4)),
                int(np.ceil((w + 4) / (1.0 - 1.0 / sigma))),
            ),
            prefer_pow2=prefer_pow2,
        )
        ds_d = 2.0 * np.pi / (nf_d * h_d)

        # Mode deconvolution in FFT order.
        k = np.fft.fftfreq(nf_d, d=1.0 / nf_d)
        deconv_d = 1.0 / es_kernel_ft(2.0 * np.pi * k / nf_d, w, kernel.beta)
        deconv.append(deconv_d)

        # Interpolation taps at (s - s_c) / ds, signed FFT indexing. The
        # window [ceil(v - w/2), ...] keeps offsets in (-w/2, w/2] for both
        # odd and even widths.
        v = (targets[axis] - s_center[axis]) / ds_d  # (m,)
        k0 = np.ceil(v - w / 2.0).astype(np.int64)
        offs = np.arange(w, dtype=np.int64)
        kk = k0[:, None] + offs[None, :]  # (m, w) signed
        tap_idx.append(np.mod(kk, nf_d).astype(np.int32))
        tap_val.append(es_kernel_grid(v[:, None] - kk, w, kernel.beta))

        nf.append(nf_d)
        h.append(float(h_d))
        ds.append(float(ds_d))
        # Amplitude pre-correction fit over the source extent (2% margin).
        xi_m = 1.02 * X * ds_d
        ft_coefs.append(
            fit_log_ft_cheb(w, kernel.beta, xi_m) if fit_precorr else None
        )
        ft_xi_max.append(xi_m)

    _check_int32_grid(nf)
    for arr in (*deconv, *tap_idx, *tap_val):
        arr.setflags(write=False)
    return Type3Plan(
        kernel=kernel,
        d=d,
        nf=tuple(nf),
        h=tuple(h),
        ds=tuple(ds),
        s_center=tuple(float(c) for c in s_center),
        deconv=tuple(deconv),
        tap_idx=tuple(tap_idx),
        tap_val=tuple(tap_val),
        n_targets=m,
        ft_coefs=tuple(ft_coefs),
        ft_xi_max=tuple(ft_xi_max),
    )


def fit_plan_precorr(plan):
    """Return ``plan`` with the log-Chebyshev pre-correction fitted.

    Fills any ``None`` entries of ``ft_coefs`` (of the 2D plan of a
    :class:`Type3LowrankZPlan`); entries the fit cannot reach stay ``None``
    (the executor then uses the quadrature). No-op for fully fitted plans.
    """
    if isinstance(plan, Type3LowrankZPlan):
        plan2d = fit_plan_precorr(plan.plan2d)
        if plan2d is plan.plan2d:
            return plan
        return dataclasses.replace(plan, plan2d=plan2d)
    if all(c is not None for c in plan.ft_coefs):
        return plan
    coefs = tuple(
        c
        if c is not None
        else fit_log_ft_cheb(plan.kernel.w, plan.kernel.beta, plan.ft_xi_max[i])
        for i, c in enumerate(plan.ft_coefs)
    )
    return dataclasses.replace(plan, ft_coefs=coefs)


def _precorr_axis(p: Type3Plan, axis: int, x_axis: torch.Tensor) -> torch.Tensor:
    """psi_hat(x * ds_axis) for the type-3 amplitude pre-correction.

    float32 uses the plan's fitted log-Chebyshev; float64 and fit-less
    plans keep the quadrature (the fit tolerance is 3e-7, float32
    territory only) -- the dtype choice of the JAX package.
    """
    xi = x_axis * p.ds[axis]
    coefs = p.ft_coefs[axis] if axis < len(p.ft_coefs) else None
    if coefs is not None and x_axis.dtype == torch.float32:
        return es_kernel_ft_cheb(xi, coefs, p.ft_xi_max[axis])
    return es_kernel_ft(xi, p.kernel.w, p.kernel.beta)


def _forward_modes(g: torch.Tensor, nf) -> torch.Tensor:
    """FFT with the +i sign convention: G_k = sum_m g_m e^{+2 pi i k m / nf}."""
    dims = tuple(range(1, 1 + len(nf)))
    return torch.fft.ifftn(g, dim=dims).mul_(float(np.prod(nf)))


def _split_cell_frac(u: torch.Tensor):
    """Decompose a grid coordinate into (integer cell, frac).

    ``u - floor(u)`` is exact in floating point (Sterbenz), so the kernel
    argument ``(cell - tap) + frac`` keeps ~ulp(1) accuracy even where
    ``u`` itself reaches 10^3-10^4 cells.
    """
    cell = torch.floor(u)
    return cell, u - cell


def _fmod_positive(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x mod n`` in [0, n] with the float semantics of ``jnp.mod``.

    fmod is exact; adding n to a small negative remainder rounds, and can
    round to exactly n (the spreader clamps and wraps that case).
    """
    r = torch.fmod(x, n)
    return torch.where(r < 0, r + n, r)


def _grid_coord(v: torch.Tensor, n: int, rdt: torch.dtype) -> torch.Tensor:
    """The spreaders' grid coordinate of ``v`` (cells) on a periodic axis of
    ``n`` cells in ``rdt``: ``v mod n`` in [0, n]. A wider ``v`` (a float32
    run's float64 chain) is reduced in its own dtype and centred into
    [-n/2, n/2] before the cast (the spreaders wrap every tap mod n, so any
    representative serves): centred, the float32 coordinate keeps the ulp
    of |v| <= n/2 rather than of values up to n -- on a (16000, ...) grid
    2^-12 of a cell for the sky's ~4,000-cell half-width, against 2^-10
    past 8,192."""
    u = _fmod_positive(v, n)
    if v.dtype == rdt:
        return u
    return torch.where(u > n / 2, u - n, u).to(rdt)  # u - n exact (Sterbenz)


def tap_tables(tap_idx, tap_val, rdtype: torch.dtype, device, sel=None, nf=None):
    """A plan's per-axis (m, w) interpolation tap tables of every target, or
    of the subset ``sel``, on ``device``: indices as int32, kernel values as
    ``rdtype``, and the ``order`` and ``runs`` the kernels take. At d = 2 the
    rows are put in :func:`~.interp.target_order` and that order (as
    positions in the subset) and the tables' :func:`~.interp.footprint_runs`
    come as int32 device tensors. At d = 3 on the grid ``nf`` the rows are
    put in :func:`~.interp.bin_order_3d`'s order (for ``rdtype``'s bin edge)
    and ``runs`` holds its bin offsets, where it plans one; at d = 1, or
    without one, both are None and the rows stay in target order. A plan's
    taps are w consecutive cells (mod nf) from the first, so order and runs
    come from the first column alone. Returns (indices, values, order,
    runs)."""
    idx = [a if sel is None else a[sel] for a in tap_idx]
    val = [a if sel is None else a[sel] for a in tap_val]
    order = runs = perm = None
    if len(idx) == 2:
        perm = target_order(idx[0][:, 0], idx[1][:, 0])
        runs = footprint_runs(idx[0][perm, :1], idx[1][perm, :1])
    elif len(idx) == 3 and nf is not None:
        perm, runs = bin_order_3d(idx, nf, torch.finfo(rdtype).bits // 8) or (None, None)
    if perm is not None:
        runs = torch.tensor(runs, dtype=torch.int32, device=device)
        order = torch.tensor(perm, dtype=torch.int32, device=device)
        idx, val = [a[perm] for a in idx], [a[perm] for a in val]
    return (tuple(torch.tensor(a, dtype=torch.int32, device=device) for a in idx),
            tuple(torch.tensor(a, dtype=rdtype, device=device) for a in val),
            order, runs)


class Type3Executor:
    """Split-phase type-3 execution on the plan's device.

    ``spread`` (pre-phase + pre-correction + ES spreading) is linear in the
    weights and accumulates across source blocks into one grid;
    ``transform`` runs the batched FFT + mode deconvolution once;
    ``interpolate`` evaluates every planned target.
    """

    # Grid channels a weight channel: 1 here, K z-modes in the low-rank-z
    # executor.
    channel_multiplier = 1

    def __init__(self, plan: Type3Plan, device="cuda"):
        self.plan = plan
        self.device = torch.device(device)
        self._tables: dict = {}

    def _deconv(self, rdtype: torch.dtype):
        """The per-axis deconvolution vectors on the device, once a dtype."""
        key = ("deconv", rdtype)
        if key not in self._tables:
            self._tables[key] = tuple(torch.tensor(a, dtype=rdtype, device=self.device)
                                      for a in self.plan.deconv)
        return self._tables[key]

    def _taps(self, rdtype: torch.dtype, sel: np.ndarray | None = None):
        """:func:`tap_tables` of every target, or of the subset ``sel``,
        built once per (dtype, subset) and kept."""
        key = ("taps", rdtype, None if sel is None else np.asarray(sel).tobytes())
        tabs = self._tables.get(key)
        if tabs is None:
            tabs = self._tables[key] = tap_tables(self.plan.tap_idx, self.plan.tap_val,
                                                  rdtype, self.device, sel, self.plan.nf)
        return tabs

    def spread(self, x: torch.Tensor, c: torch.Tensor, grid=None) -> torch.Tensor:
        """Spread sources onto the fine grid.

        x: (d, n) source coords within the planned extent, in c's real
        dtype or float64 (a float32 run's float64 chain: the pre-phase and
        the grid coordinates are reduced in float64 and cast after); c: (C,
        n) complex. Accumulates into ``grid`` (C, *nf) in place when given
        -- the engine carries one grid across source blocks instead of
        allocating and summing one per block -- else into a new grid.
        """
        p = self.plan
        phase = sum(p.s_center[axis] * x[axis] for axis in range(p.d))
        return self._spread_weights(x, c * self._prephase(x, phase, c.real.dtype)[None, :],
                                    grid)

    def _prephase(self, x: torch.Tensor, phase: torch.Tensor, rdt: torch.dtype) -> torch.Tensor:
        """exp(i phase) over the amplitude pre-correction of the spread
        axes: (n,) complex in ``rdt``'s complex dtype. A float64 phase is
        reduced mod 2 pi before the cast (:func:`~.direct.phasor`); the
        pre-correction is evaluated at x cast to ``rdt``."""
        p = self.plan
        xr = x.to(rdt)
        corr = torch.ones_like(xr[0])
        for axis in range(p.d):
            corr = corr * _precorr_axis(p, axis, xr[axis])
        return phasor(phase, rdt) / corr

    def _spread_weights(self, x: torch.Tensor, wts: torch.Tensor, grid) -> torch.Tensor:
        """The ES spread of the (C', n) weights at the sources' first d
        coordinates into ``grid`` (C', *nf), or a new grid; the grid
        coordinates are reduced in x's dtype and cast to the weights' real
        dtype after (:func:`_grid_coord`)."""
        p = self.plan
        u = [_grid_coord(x[axis] / p.h[axis], p.nf[axis], wts.real.dtype)
             for axis in range(p.d)]
        if grid is None:
            grid = torch.zeros((wts.shape[0],) + tuple(p.nf), dtype=wts.dtype,
                               device=wts.device)
        spread_nd(u, wts, grid, p.kernel.w, p.kernel.beta)
        return grid

    def transform(self, g: torch.Tensor) -> torch.Tensor:
        """FFT and mode deconvolution of the (C, *nf) grid; one new
        grid-sized tensor, scaled in place."""
        p = self.plan
        G = _forward_modes(g, p.nf)
        deconv = self._deconv(G.real.dtype)
        for axis in range(p.d):
            s = [1] * (1 + p.d)
            s[1 + axis] = p.nf[axis]
            G.mul_(deconv[axis].reshape(s))
        return G

    def _tiles(self, rdtype: torch.dtype, sel: np.ndarray | None = None):
        """The owned-tile lists of the interpolation's adjoint on the card
        (:func:`~.interp.tile_tensors`) of the d = 2 tables and runs that
        :meth:`_taps` gives the kernels for ``rdtype`` and every target, or
        ``sel``: built on the host once per (dtype, subset) from those very
        tensors, so that the lists and the tables' row order come from one
        decision, and kept beside them."""
        key = ("tiles", rdtype, None if sel is None else np.asarray(sel).tobytes())
        tiles = self._tables.get(key)
        if tiles is None:
            (iy, ix), _, _, runs = self._taps(rdtype, sel)
            tiles = self._tables[key] = tile_tensors(
                iy.cpu().numpy(), ix.cpu().numpy(), runs.cpu().numpy(), self.plan.nf,
                self.device)
        return tiles

    def interpolate(self, G: torch.Tensor, sel: np.ndarray | None = None) -> torch.Tensor:
        """Evaluate every planned target, or the subset ``sel`` (one beam
        pair's baselines), from G: (C, m) complex in target (subset)
        order."""
        return self.interpolate_pairs(G, [sel])[0]

    def interpolate_pairs(self, G: torch.Tensor, sels) -> list:
        """Evaluate each beam pair's targets ``sels[p]`` (None: every
        target) from its channels of G, the p-th of ``len(sels)`` equal
        slices: a list of (C / len(sels), m_p) complex in subset order. At
        d = 2 one :func:`~.interp.interp_pairs` call covers every pair, so
        a gradient of G is one node that writes one gradient (on the card
        through the owned-tile lists of :meth:`_tiles`, built only then)."""
        G = G.contiguous()
        cp = G.shape[0] // len(sels)
        rdt = G.real.dtype
        if self.plan.d != 2:
            outs = []
            for p, sel in enumerate(sels):
                ti, tv, order, runs = self._taps(rdt, sel)
                outs.append(interp_nd(G[p * cp:(p + 1) * cp], ti, tv, order=order, runs=runs))
            return outs
        grad = torch.is_grad_enabled() and G.requires_grad and G.is_cuda
        pairs = []
        for p, sel in enumerate(sels):
            ti, tv, order, runs = self._taps(rdt, sel)
            tiles = self._tiles(rdt, sel) if grad else None
            pairs.append((p * cp, (p + 1) * cp, (*ti, *tv, order, runs, tiles)))
        return interp_pairs(G, pairs)


class Type3LowrankZExecutor(Type3Executor):
    """Split-phase 3D type-3 execution via the low-rank z factorization.

    Drop-in for :class:`Type3Executor` with (3, n) source coordinates: the
    engine's spread -> transform -> interpolate steps are unchanged, grids
    carry C*K channels in the c*K + k layout (``channel_multiplier``), and
    :meth:`interpolate` contracts the K z-modes with the plan's target
    coefficients on the device. ``.plan`` is the inner 2D plan, so grid
    sizing sees the true 2D fine grid. The spread and interpolation run
    the hand-written kernels of :mod:`.spread` and :mod:`.interp` at C*K
    channels; the Chebyshev weights and the contraction are torch ops.
    """

    def __init__(self, zplan: Type3LowrankZPlan, device="cuda"):
        super().__init__(zplan.plan2d, device=device)
        self.zplan = zplan

    @property
    def channel_multiplier(self) -> int:
        return self.zplan.K

    def spread(self, x: torch.Tensor, c: torch.Tensor, grid=None) -> torch.Tensor:
        """x: (3, n) source coords (c's real dtype or float64, as
        :meth:`Type3Executor.spread`); c: (C, n). Accumulates into ``grid``
        (C*K, nfy, nfx) in place when given, else into a new grid."""
        p, zp = self.plan, self.zplan
        # Pre-phase: 2D target centering plus the z-center factor; the
        # pre-correction applies to the spread axes only.
        phase = p.s_center[0] * x[0] + p.s_center[1] * x[1] + zp.s_center_z * x[2]
        rdt = c.real.dtype
        wts = c * self._prephase(x, phase, rdt)[None, :]
        # Chebyshev z-modes. Clamp: masked (below-horizon) sources carry
        # zero weight but may sit outside [zlo, zhi], where T_k explodes.
        t = torch.clamp((x[2] - zp.x_center_z) / zp.x_half_z, -1.0, 1.0).to(rdt)
        cheb = [torch.ones_like(t)]
        if zp.K > 1:
            cheb.append(t)
        for _ in range(2, zp.K):
            cheb.append(2.0 * t * cheb[-1] - cheb[-2])
        f = torch.stack(cheb[: zp.K])  # (K, n)
        C, n = wts.shape
        wts_k = (wts[:, None, :] * f[None, :, :]).reshape(C * zp.K, n)
        return self._spread_weights(x, wts_k, grid)

    def _g(self, cdtype: torch.dtype, sel: np.ndarray | None):
        """The (m, K) target coefficients of every target, or of ``sel``,
        on the device, once per (dtype, subset)."""
        key = ("g", cdtype, None if sel is None else np.asarray(sel).tobytes())
        g = self._tables.get(key)
        if g is None:
            g_host = self.zplan.g if sel is None else self.zplan.g[sel]
            g = self._tables[key] = torch.tensor(g_host, dtype=cdtype, device=self.device)
        return g

    def interpolate_pairs(self, G: torch.Tensor, sels) -> list:
        """(C*K, nfy, nfx) -> each pair's (C / len(sels), m[sel]): the 2D
        taps of its C*K / len(sels) channels, then the z-mode contraction."""
        K = self.zplan.K
        return [torch.einsum("ckm,mk->cm", o.reshape(o.shape[0] // K, K, o.shape[1]),
                             self._g(G.dtype, sel))
                for o, sel in zip(super().interpolate_pairs(G, sels), sels)]


def make_type3_lowrank_z_fn(zplan: Type3LowrankZPlan, device="cuda"):
    """(x (3, n), c (C, n)) -> (C, m). One-shot convenience wrapper."""
    ex = Type3LowrankZExecutor(zplan, device=device)

    def run(x, c):
        return ex.interpolate(ex.transform(ex.spread(x, c)))

    return run


def make_type3_fn(plan: Type3Plan, device="cuda"):
    """(x (d, n), c (C, n)) -> (C, m). One-shot convenience wrapper."""
    ex = Type3Executor(plan, device=device)

    def run(x, c):
        return ex.interpolate(ex.transform(ex.spread(x, c)))

    return run


class Type1Executor:
    """Split-phase ES type-1 execution on the plan's device.

    ``spread`` is linear in the weights and accumulates source blocks into
    one (C, *nf) fine grid; ``transform`` is the FFT; ``gather`` and
    ``gather_padded`` read the requested modes with their deconvolution,
    in the exact executor's output layout (``nufft/type1.py``), so the
    engine's assembly takes either executor.
    """

    channel_multiplier = 1

    def __init__(self, plan: Type1Plan, device="cuda"):
        self.plan = plan
        self.device = torch.device(device)
        self._tables: dict = {}

    def spread(self, x: torch.Tensor, c: torch.Tensor, grid=None) -> torch.Tensor:
        """x: (d, n) radians (2 pi periodic), in c's real dtype or float64;
        c: (C, n) complex. Accumulates
        into ``grid`` (C, *nf) in place when given (the engine carries one
        grid across source blocks), else into a new grid, and returns it.
        Where c requires a gradient, the 2D spread goes through
        :class:`~.spread.SpreadFunction`."""
        p = self.plan
        # Float64 phases (the engine's float32 runs give them) are reduced
        # to grid coordinates in float64 and cast after.
        u = [_grid_coord(x[axis] / (2.0 * np.pi) * p.nf[axis], p.nf[axis], c.real.dtype)
             for axis in range(p.d)]
        if grid is None:
            grid = torch.zeros((c.shape[0],) + tuple(p.nf), dtype=c.dtype, device=c.device)
        spread_nd(u, c, grid, p.kernel.w, p.kernel.beta)
        return grid

    def transform(self, g: torch.Tensor) -> torch.Tensor:
        return _forward_modes(g, self.plan.nf)

    def _gather_tables(self, rdtype: torch.dtype, key, sel):
        """The flat FFT-order positions (int64) and deconvolution factors
        (``rdtype``) of the targets ``sel`` (an index array of any shape, or
        None for every target) on the device, once per (dtype, key)."""
        key = ("gather", rdtype, key)
        tabs = self._tables.get(key)
        if tabs is None:
            p = self.plan
            idx = p.gather_idx if sel is None else p.gather_idx[sel]
            dec = p.gather_deconv if sel is None else p.gather_deconv[sel]
            tabs = self._tables[key] = (
                torch.as_tensor(np.asarray(idx, dtype=np.int64), device=self.device),
                torch.tensor(dec, dtype=rdtype, device=self.device),
            )
        return tabs

    def gather(self, G: torch.Tensor, sel: np.ndarray | None = None) -> torch.Tensor:
        """The deconvolved modes of every target, or of the subset ``sel``,
        from the (C, *nf) FFT output: (C, m)."""
        key = None if sel is None else ("sel", np.asarray(sel).tobytes())
        idx, dec = self._gather_tables(G.real.dtype, key, sel)
        return G.reshape(G.shape[0], -1)[:, idx] * dec[None, :]

    def gather_padded(self, G: torch.Tensor, sel_pad: np.ndarray) -> torch.Tensor:
        """Batched gather over the padded pair routing: G (P * nf2, *nf)
        pair-major, ``sel_pad`` (P, m_max) target rows; returns (P, nf2,
        m_max)."""
        P, m_max = sel_pad.shape
        flat = G.reshape(P, -1, int(np.prod(self.plan.nf)))
        idx, dec = self._gather_tables(G.real.dtype, ("pad", sel_pad.shape, sel_pad.tobytes()),
                                       sel_pad)
        sub = torch.gather(flat, 2, idx[:, None, :].expand(P, flat.shape[1], m_max))
        return sub * dec[:, None, :]


def make_type1_fn(plan: Type1Plan, device="cuda"):
    """(x (d, n) radians, c (C, n)) -> (C, m). One-shot convenience wrapper."""
    ex = Type1Executor(plan, device=device)

    def run(x, c):
        return ex.gather(ex.transform(ex.spread(x, c)))

    return run


@dataclass(frozen=True)
class Type2Plan:
    """Plan for a d-dimensional type-2 transform (modes -> points).

    c_j = sum_k f_k exp(+i k . x_j) for a static integer mode list and
    static evaluation points: the transpose of the type-1 (same +i sign
    convention), sharing its fine grid, kernel and deconvolution table.

        scatter-add (f * deconv) at the mode positions  [gather^T]
        -> batched +i-sign FFT (symmetric matrix)        [FFT^T]
        -> ES-kernel tap interpolation at the points     [spread^T]

    The points are planned on the host in float64, like type-3's targets.
    """

    kernel: ESKernel
    d: int
    nf: tuple[int, ...]
    # Per-mode scatter positions in FFT-order flat indexing, (m,) int32,
    # and deconvolution factors, (m,) float64 (the type-1 gather tables).
    scatter_idx: np.ndarray
    scatter_deconv: np.ndarray
    n_modes: int
    # Per-point interpolation taps per dim: indices (n, w) int32 (mod nf
    # applied) and kernel values (n, w) float64.
    tap_idx: tuple[np.ndarray, ...]
    tap_val: tuple[np.ndarray, ...]
    n_points: int


def plan_type2(
    x: np.ndarray,
    modes: np.ndarray,
    eps: float,
    upsample_factor: float = 2.0,
    prefer_pow2: bool = False,
) -> Type2Plan:
    """Plan a type-2 transform: integer ``modes`` evaluated at points ``x``.

    Parameters
    ----------
    x
        Evaluation points in radians (2 pi periodic), shape (d, n), host
        data: the interpolation taps are planned from them in float64.
    modes
        Integer mode indices, shape (d, m). May be negative (FFT wrap);
        duplicate modes sum (scatter-add), the type-1 gather's transpose.
    eps, upsample_factor
        Accuracy / oversampling, as for :func:`plan_type1`.
    """
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    t1 = plan_type1(modes, eps, upsample_factor, prefer_pow2)
    if x.shape[0] != t1.d:
        raise ValueError(
            f"x has {x.shape[0]} dims but modes have {t1.d}"
        )
    w = t1.kernel.w
    tap_idx, tap_val = [], []
    for axis in range(t1.d):
        nf_d = t1.nf[axis]
        u = np.mod(x[axis] / (2.0 * np.pi) * nf_d, nf_d)  # (n,) grid units
        i0 = np.ceil(u - w / 2.0).astype(np.int64)
        cells = i0[:, None] + np.arange(w, dtype=np.int64)[None, :]
        tap_idx.append(np.mod(cells, nf_d).astype(np.int32))
        tap_val.append(es_kernel_grid(u[:, None] - cells, w, t1.kernel.beta))
    for arr in (*tap_idx, *tap_val):
        arr.setflags(write=False)
    return Type2Plan(
        kernel=t1.kernel,
        d=t1.d,
        nf=t1.nf,
        scatter_idx=t1.gather_idx,
        scatter_deconv=t1.gather_deconv,
        n_modes=t1.n_targets,
        tap_idx=tuple(tap_idx),
        tap_val=tuple(tap_val),
        n_points=x.shape[1],
    )


class Type2Executor:
    """Split-phase type-2 execution on the plan's device.

    ``interp`` is linear in the grid, so one ``scatter`` + ``transform``
    can serve several point blocks.
    """

    def __init__(self, plan: Type2Plan, device="cuda"):
        self.plan = plan
        self.device = torch.device(device)
        self._tables: dict = {}

    def scatter(self, f: torch.Tensor) -> torch.Tensor:
        """f: (C, m) mode coefficients. Returns the fine mode grid (C, *nf):
        ``index_add_`` of f times the deconvolution into a zero grid, on the
        real and imaginary planes (duplicate modes add)."""
        p = self.plan
        key = ("scatter", f.real.dtype)
        tabs = self._tables.get(key)
        if tabs is None:
            tabs = self._tables[key] = (
                torch.as_tensor(np.asarray(p.scatter_idx, dtype=np.int64), device=self.device),
                torch.tensor(p.scatter_deconv, dtype=f.real.dtype, device=self.device),
            )
        idx, dec = tabs
        vals = f * dec[None, :]
        g = torch.zeros((f.shape[0], int(np.prod(p.nf))), dtype=f.dtype, device=f.device)
        torch.view_as_real(g).index_add_(1, idx, torch.view_as_real(vals))
        return g.reshape((f.shape[0],) + tuple(p.nf))

    def transform(self, G: torch.Tensor) -> torch.Tensor:
        # e^{+2 pi i k m / nf} is symmetric in (k, m): the +i-sign FFT of
        # the type-1 is its own transpose.
        return _forward_modes(G, self.plan.nf)

    def _taps(self, rdtype: torch.dtype, lo: int, hi: int):
        """:func:`tap_tables` of points [lo, hi), once per (dtype, block)."""
        key = ("taps", rdtype, lo, hi)
        tabs = self._tables.get(key)
        if tabs is None:
            sel = None if (lo, hi) == (0, self.plan.n_points) else np.arange(lo, hi)
            tabs = self._tables[key] = tap_tables(self.plan.tap_idx, self.plan.tap_val,
                                                  rdtype, self.device, sel, self.plan.nf)
        return tabs

    def interp(self, g: torch.Tensor, point_block: int | None = None) -> torch.Tensor:
        """Evaluate the (C, *nf) spatial fine grid from :meth:`transform` at
        the planned points: (C, n_points).

        ``point_block`` runs the points in blocks of that many (a launch a
        block, each block's tables kept); the result is the same for every
        block. n_points = 0 gives (C, 0); a block below 1 raises.
        """
        n = self.plan.n_points
        if n == 0:
            return torch.zeros((g.shape[0], 0), dtype=g.dtype, device=g.device)
        if point_block is None or point_block >= n:
            point_block = n
        elif point_block < 1:
            raise ValueError(f"point_block must be >= 1, got {point_block}")
        g = g.contiguous()
        out = []
        for lo in range(0, n, point_block):
            ti, tv, order, runs = self._taps(g.real.dtype, lo, min(lo + point_block, n))
            out.append(interp_nd(g, ti, tv, order=order, runs=runs))
        return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def make_type2_fn(plan: Type2Plan, point_block: int | None = None, device="cuda"):
    """(f (C, m) mode coefficients) -> (C, n_points). One-shot wrapper."""
    ex = Type2Executor(plan, device=device)

    def run(f):
        return ex.interp(ex.transform(ex.scatter(f)), point_block=point_block)

    return run
