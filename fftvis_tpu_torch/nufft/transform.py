"""Type-3 NUFFT: host planning (NumPy) + device execution (torch).

The port's counterpart of ``fftvis_tpu/nufft/transform.py`` for the type-3
transform

    pre-phase + pre-correction -> ES-spread -> batched (i)FFT ->
    grid deconvolution -> ES-interpolation at the nonuniform targets

in 2D (coplanar arrays, :class:`Type3Executor`) and in 3D through the
low-rank z factorization (non-coplanar arrays,
:class:`Type3LowrankZExecutor`: K Chebyshev z modes ride the 2D spread and
interpolation as C*K channels, then a contraction with host-planned target
coefficients). Planning (:func:`plan_type3`, :func:`plan_type3_lowrank_z`,
:func:`fit_plan_precorr`) is a NumPy copy and gives exactly the JAX
package's plan arrays. Execution runs on the plan's
torch device: the spread and interpolation go through the hand-written CUDA
kernels of :mod:`.spread` and :mod:`.interp` on a CUDA tensor and through
their plain torch versions on a CPU tensor; the FFT is ``torch.fft`` (cuFFT
on the card).

Sign convention (finufft default, isign=+1): f(s) = sum_j c_j exp(+i s . x_j).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .interp import footprint_runs, interp, target_order
from .kernels import (
    ESKernel,
    es_kernel_ft,
    es_kernel_ft_cheb,
    es_kernel_grid,
    fit_log_ft_cheb,
    next_fast_size,
)
from .spread import spread


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


class Type3Executor:
    """Split-phase coplanar type-3 execution on the plan's device.

    ``spread`` (pre-phase + pre-correction + ES spreading) is linear in the
    weights and accumulates across source blocks into one grid;
    ``transform`` runs the batched FFT + mode deconvolution once;
    ``interpolate`` evaluates every planned target.
    """

    # Grid channels a weight channel: 1 here, K z-modes in the low-rank-z
    # executor.
    channel_multiplier = 1

    def __init__(self, plan: Type3Plan, device="cuda"):
        if plan.d != 2:
            # The engine's 3D arrays take Type3LowrankZExecutor; a full 3D
            # fine grid belongs to the public NUFFT surface.
            raise NotImplementedError(
                f"d={plan.d} Type3Executor (the public NUFFT surface's 3D "
                "grid) is ROADMAP item 12"
            )
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
        """The tap tables of every target, or of the subset ``sel``, on the
        device, built once per (dtype, subset) and kept: indices as int32,
        kernel values as ``rdtype``, rows put in
        :func:`~.interp.target_order`, then that order (as positions in the
        subset) and the tables' :func:`~.interp.footprint_runs` as int32
        device tensors. A plan's taps are w consecutive cells (mod nf) from
        the first, so order and runs come from the first column alone."""
        key = ("taps", rdtype, None if sel is None else np.asarray(sel).tobytes())
        tabs = self._tables.get(key)
        if tabs is None:
            p, dev = self.plan, self.device
            idx = [a if sel is None else a[sel] for a in p.tap_idx]
            val = [a if sel is None else a[sel] for a in p.tap_val]
            order = target_order(idx[0][:, 0], idx[1][:, 0])
            runs = footprint_runs(idx[0][order, :1], idx[1][order, :1])
            tabs = (
                tuple(torch.tensor(a[order], dtype=torch.int32, device=dev) for a in idx),
                tuple(torch.tensor(a[order], dtype=rdtype, device=dev) for a in val),
                torch.tensor(order, dtype=torch.int32, device=dev),
                torch.tensor(runs, dtype=torch.int32, device=dev),
            )
            self._tables[key] = tabs
        return tabs

    def spread(self, x: torch.Tensor, c: torch.Tensor, grid=None) -> torch.Tensor:
        """Spread sources onto the fine grid.

        x: (2, n) source coords within the planned extent; c: (C, n)
        complex. Accumulates into ``grid`` (C, nfy, nfx) in place when
        given -- the engine carries one grid across source blocks instead
        of allocating and summing one per block -- else into a new grid.
        """
        p = self.plan
        phase = sum(p.s_center[axis] * x[axis] for axis in range(p.d))
        return self._spread_weights(x, c * self._prephase(x, phase)[None, :], grid)

    def _prephase(self, x: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
        """exp(i phase) over the amplitude pre-correction of the two spread
        axes: (n,) complex."""
        p = self.plan
        corr = torch.ones_like(x[0])
        for axis in range(p.d):
            corr = corr * _precorr_axis(p, axis, x[axis])
        return torch.complex(torch.cos(phase), torch.sin(phase)) / corr

    def _spread_weights(self, x: torch.Tensor, wts: torch.Tensor, grid) -> torch.Tensor:
        """The ES spread of the (C', n) weights at the sources' first two
        coordinates into ``grid`` (C', nfy, nfx), or a new grid."""
        p = self.plan
        u = [_fmod_positive(x[axis] / p.h[axis], p.nf[axis]) for axis in range(p.d)]
        if grid is None:
            grid = torch.zeros((wts.shape[0],) + tuple(p.nf), dtype=wts.dtype,
                               device=wts.device)
        spread(u[0], u[1], wts, grid, p.kernel.w, p.kernel.beta)
        return grid

    def transform(self, g: torch.Tensor) -> torch.Tensor:
        """FFT and mode deconvolution of the (C, nfy, nfx) grid; one new
        grid-sized tensor, scaled in place."""
        p = self.plan
        G = _forward_modes(g, p.nf)
        deconv = self._deconv(G.real.dtype)
        for axis in range(p.d):
            s = [1] * (1 + p.d)
            s[1 + axis] = p.nf[axis]
            G.mul_(deconv[axis].reshape(s))
        return G

    def interpolate(self, G: torch.Tensor, sel: np.ndarray | None = None) -> torch.Tensor:
        """Evaluate every planned target, or the subset ``sel`` (one beam
        pair's baselines), from G: (C, m) complex in target (subset)
        order."""
        ti, tv, order, runs = self._taps(G.real.dtype, sel)
        return interp(G.contiguous(), ti[0], ti[1], tv[0], tv[1], order=order, runs=runs)


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
        """x: (3, n) source coords; c: (C, n). Accumulates into ``grid``
        (C*K, nfy, nfx) in place when given, else into a new grid."""
        p, zp = self.plan, self.zplan
        # Pre-phase: 2D target centering plus the z-center factor; the
        # pre-correction applies to the spread axes only.
        phase = p.s_center[0] * x[0] + p.s_center[1] * x[1] + zp.s_center_z * x[2]
        wts = c * self._prephase(x, phase)[None, :]
        # Chebyshev z-modes. Clamp: masked (below-horizon) sources carry
        # zero weight but may sit outside [zlo, zhi], where T_k explodes.
        t = torch.clamp((x[2] - zp.x_center_z) / zp.x_half_z, -1.0, 1.0)
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

    def interpolate(self, G: torch.Tensor, sel: np.ndarray | None = None) -> torch.Tensor:
        """(C*K, nfy, nfx) -> (C, m[sel]): the 2D taps of all C*K channels,
        then the z-mode contraction."""
        o = super().interpolate(G, sel)  # (C*K, m)
        K = self.zplan.K
        o = o.reshape(o.shape[0] // K, K, o.shape[1])
        return torch.einsum("ckm,mk->cm", o, self._g(G.dtype, sel))


def make_type3_lowrank_z_fn(zplan: Type3LowrankZPlan, device="cuda"):
    """(x (3, n), c (C, n)) -> (C, m). One-shot convenience wrapper."""
    ex = Type3LowrankZExecutor(zplan, device=device)

    def run(x, c):
        return ex.interpolate(ex.transform(ex.spread(x, c)))

    return run
