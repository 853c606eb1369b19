"""Type-3 NUFFT: host planning (NumPy) + device execution (torch).

The port's counterpart of ``fftvis_tpu/nufft/transform.py`` for the coplanar
type-3 transform

    pre-phase + pre-correction -> ES-spread -> batched (i)FFT ->
    grid deconvolution -> ES-interpolation at the nonuniform targets

Planning (:func:`plan_type3`, :func:`fit_plan_precorr`) is a NumPy copy and
gives exactly the JAX package's plan arrays. Execution runs on the plan's
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


def fit_plan_precorr(plan: Type3Plan) -> Type3Plan:
    """Return ``plan`` with the log-Chebyshev pre-correction fitted.

    Fills any ``None`` entries of ``ft_coefs``; entries the fit cannot reach
    stay ``None`` (the executor then uses the quadrature). No-op for fully
    fitted plans.
    """
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
    return torch.fft.ifftn(g, dim=dims) * float(np.prod(nf))


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

    def __init__(self, plan: Type3Plan, device="cpu"):
        if plan.d != 2:
            raise NotImplementedError(
                f"d={plan.d} type-3 (non-coplanar arrays) is ROADMAP item 8"
            )
        self.plan = plan
        self.device = torch.device(device)
        self._tables: dict = {}

    def _device_tables(self, rdtype: torch.dtype):
        """Deconvolution vectors and tap tables on the device, uploaded once
        per real dtype: indices as int32, kernel values as ``rdtype``. The
        tap tables' rows are put in :func:`~.interp.target_order` on the
        device; the order and the tables' :func:`~.interp.footprint_runs`
        follow as int32 device tensors. A plan's taps are w consecutive
        cells (mod nf) from the first, so the runs come from the first
        column alone."""
        tabs = self._tables.get(rdtype)
        if tabs is None:
            p, dev = self.plan, self.device
            order = target_order(p.tap_idx[0][:, 0], p.tap_idx[1][:, 0])
            runs = footprint_runs(p.tap_idx[0][order, :1], p.tap_idx[1][order, :1])
            rows = torch.tensor(order, dtype=torch.int32, device=dev)
            tabs = (
                tuple(torch.tensor(a, dtype=rdtype, device=dev) for a in p.deconv),
                tuple(
                    torch.tensor(a, dtype=torch.int32, device=dev).index_select(0, rows)
                    for a in p.tap_idx
                ),
                tuple(
                    torch.tensor(a, dtype=rdtype, device=dev).index_select(0, rows)
                    for a in p.tap_val
                ),
                rows,
                torch.tensor(runs, dtype=torch.int32, device=dev),
            )
            self._tables[rdtype] = tabs
        return tabs

    def spread(self, x: torch.Tensor, c: torch.Tensor, grid=None) -> torch.Tensor:
        """Spread sources onto the fine grid.

        x: (2, n) source coords within the planned extent; c: (C, n)
        complex. Accumulates into ``grid`` (C, nfy, nfx) in place when
        given -- the engine carries one grid across source blocks instead
        of allocating and summing one per block -- else into a new grid.
        """
        p = self.plan
        w, beta = p.kernel.w, p.kernel.beta
        phase = sum(p.s_center[axis] * x[axis] for axis in range(p.d))
        corr = torch.ones_like(x[0])
        for axis in range(p.d):
            corr = corr * _precorr_axis(p, axis, x[axis])
        pre = torch.complex(torch.cos(phase), torch.sin(phase)) / corr
        wts = c * pre[None, :]

        u = [_fmod_positive(x[axis] / p.h[axis], p.nf[axis]) for axis in range(p.d)]
        if grid is None:
            grid = torch.zeros((c.shape[0],) + tuple(p.nf), dtype=c.dtype,
                               device=c.device)
        spread(u[0], u[1], wts, grid, w, beta)
        return grid

    def transform(self, g: torch.Tensor) -> torch.Tensor:
        p = self.plan
        G = _forward_modes(g, p.nf)
        deconv = self._device_tables(G.real.dtype)[0]
        for axis in range(p.d):
            s = [1] * (1 + p.d)
            s[1 + axis] = p.nf[axis]
            G = G * deconv[axis].reshape(s)
        return G

    def interpolate(self, G: torch.Tensor) -> torch.Tensor:
        """Evaluate every planned target from G: (C, m) complex."""
        _, ti, tv, order, runs = self._device_tables(G.real.dtype)
        return interp(G.contiguous(), ti[0], ti[1], tv[0], tv[1], order=order, runs=runs)
