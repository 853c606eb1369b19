"""Exact type-1 transform of a gridded array: host planning (NumPy) and
device execution (torch).

The port of ``Type1ExactPlan`` / ``plan_type1_exact`` /
``Type1ExactExecutor`` (``fftvis_tpu/nufft/transform.py``). For a gridded
array every requested mode is an integer |k| <= kmax on the lattice, so

    V_k = sum_s c_s exp(+i (ky xy_s + kx xx_s))

factors exactly: two (n, nm) complex phasor matrices, one a lattice axis,
and one complex product. There is no ES kernel, no FFT, no deconvolution and
no eps truncation; the mode grid itself is the accumulator, and the result
is gathered at the baselines' modes.

Each axis splits k = khi K + klo with K ~ sqrt(nm), so a factor costs n
(nhi + K) sin/cos instead of n nm; the mode grid is padded to nhi * K rows
an axis (padding modes are computed and never gathered). The factor's
phase uses an error-free integer-cell split of the grid coordinate: k *
cell is exact while kmax * nm < 2^23 in float32 (the planner checks it), and
``q - nm * round(q / nm)`` reduces it exactly; ``torch.round`` rounds half to
even, as ``jnp.round`` does.

The product runs on cuBLAS: the (n, nmy * nmx) outer product of the two
factors and one (C, n) x (n, nmy * nmx) ``addmm``. The JAX package also
had a factored form (c times one factor, contracted against the other) and
chose between them by the TPU's matrix-unit tile fill; on the card the
outer form is faster in both dtypes, and the engine's source block bounds
its factor (``cuda/engine.py`` ``source_block``). Float32 products run in
full float32 (the engine turns TF32 off). ``products`` counts the products
``spread`` adds (one a source block), on any device: a count of the path's
source blocks, not of a hand-written kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .transform import _check_int32_grid, _fmod_positive

products = 0


@dataclass(frozen=True)
class Type1ExactPlan:
    """Plan for the exact separable-DFT type-1 (gridded-array) transform.

    ``nf`` is the MODE grid -- 2 kmax + 1 per axis, rounded up to ``nhi *
    K`` -- not an oversampled fine grid.
    """

    d: int
    nf: tuple[int, ...]
    kmax: tuple[int, ...]
    # Per-axis split k = khi * K + klo with K ~ sqrt(nm): (K, nhi) pairs.
    split: tuple[tuple[int, int], ...]
    # Per-target gather positions into the (kmax-shifted, padded) mode grid.
    gather_idx: np.ndarray
    n_targets: int


def plan_type1_exact(modes: np.ndarray) -> Type1ExactPlan:
    """Plan an exact type-1 at integer ``modes`` (d, m) (no eps: the
    transform is exact up to floating-point roundoff)."""
    modes = np.atleast_2d(np.asarray(modes, dtype=np.int64))
    d, m = modes.shape
    kmax = tuple(
        int(max(np.max(np.abs(modes[axis])) if m else 1, 1))
        for axis in range(d)
    )
    split = []
    nf = []
    for km in kmax:
        nm = 2 * km + 1
        K = max(int(round(np.sqrt(nm))), 1)
        nhi = -(-nm // K)
        split.append((K, nhi))
        nf.append(nhi * K)
    _check_int32_grid(nf)
    flat = np.zeros(m, dtype=np.int64)
    for axis in range(d):
        flat = flat * nf[axis] + (modes[axis] + kmax[axis])
    gather_idx = flat.astype(np.int32)
    gather_idx.setflags(write=False)
    return Type1ExactPlan(
        d=d, nf=tuple(nf), kmax=kmax, split=tuple(split),
        gather_idx=gather_idx, n_targets=m,
    )


class Type1ExactExecutor:
    """Exact type-1 via separable DFT factors and one complex product, on
    the plan's device.

    ``spread`` is linear in the weights and accumulates source blocks into
    one (C, nmy, nmx) mode grid; ``transform`` is the identity; ``gather``
    and ``gather_padded`` read the baselines' modes.
    """

    def __init__(self, plan: Type1ExactPlan, device="cuda"):
        if plan.d != 2:
            raise ValueError("Type1ExactExecutor supports 2D mode grids")
        self.plan = plan
        self.device = torch.device(device)
        self._gather = {}

    def _factor(self, cell: torch.Tensor, frac: torch.Tensor, axis: int) -> torch.Tensor:
        """E[s, j] = exp(+2 pi i (j - kmax) u_s / nm), (n, nm) complex, for
        ``u`` = ``cell`` + ``frac`` in [0, nm] (the integer cell and the
        fraction, in the working dtype); rows j >= 2 kmax + 1 are padding
        modes."""
        nm = int(self.plan.nf[axis])
        km = int(self.plan.kmax[axis])
        K, nhi = self.plan.split[axis]

        def phases(kvals, reduce_mod):
            q = kvals[None, :] * cell[:, None]  # integer product, exact
            if reduce_mod:
                q = q - nm * torch.round(q / nm)  # into ~[-nm/2, nm/2]
            arg = (q + kvals[None, :] * frac[:, None]) * (2.0 * np.pi / nm)
            return torch.complex(torch.cos(arg), torch.sin(arg))

        khi = torch.arange(nhi, dtype=cell.dtype, device=cell.device) * K - km
        klo = torch.arange(K, dtype=cell.dtype, device=cell.device)  # |klo cell| < K nm
        a = phases(khi, True)  # (n, nhi)
        b = phases(klo, False)  # (n, K)
        return (a[:, :, None] * b[:, None, :]).reshape(cell.shape[0], nm)

    def spread(self, x: torch.Tensor, c: torch.Tensor, grid=None) -> torch.Tensor:
        """Add the sources' modes to the (C, nmy, nmx) grid.

        x: (2, n) lattice phases in radians (2 pi periodic), in c's real
        dtype or float64; c: (C, n) complex. Accumulates into ``grid`` in
        place when given (the engine carries one grid across source blocks),
        else into a new grid, and returns it; where c or the grid requires a
        gradient, the sum is a new grid. The (n, nmy * nmx) outer factor is
        built whole: the caller bounds n.
        """
        p = self.plan
        nmy, nmx = (int(v) for v in p.nf)
        C, n = c.shape
        rdt = c.real.dtype
        if grid is None:
            grid = torch.zeros((C, nmy, nmx), dtype=c.dtype, device=c.device)
        ey, ex = (self._factor(*self._cell_frac(x[axis], axis, rdt), axis)
                  for axis in range(p.d))  # (n, nmy), (n, nmx)
        outer = (ey[:, :, None] * ex[:, None, :]).reshape(n, nmy * nmx)
        flat = grid.view(C, nmy * nmx)
        if torch.is_grad_enabled() and (c.requires_grad or grid.requires_grad):
            # Out of place under autograd: the product records its factors,
            # and no view of the carried grid is written.
            grid = torch.addmm(flat, c, outer).view(C, nmy, nmx)
        else:
            flat.addmm_(c, outer)
        global products
        products += 1
        return grid

    def _cell_frac(self, x: torch.Tensor, axis: int, rdt: torch.dtype):
        """The grid coordinate u = (x / 2 pi) nm mod nm of the phases ``x``
        split into its integer cell and fraction in x's dtype (float64 on a
        float32 run's float64 chain: u reaches nm ~ 10^3 cells, and float32
        would round it to ~1e-4 of a cell), then cast to ``rdt``."""
        nm = self.plan.nf[axis]
        u = _fmod_positive(x / (2.0 * np.pi) * nm, nm)
        cell = torch.floor(u)
        return cell.to(rdt), (u - cell).to(rdt)  # u - cell exact (Sterbenz)

    def transform(self, g: torch.Tensor) -> torch.Tensor:
        return g  # the mode grid IS the accumulator

    def _index(self, key, idx: np.ndarray) -> torch.Tensor:
        t = self._gather.get(key)
        if t is None:
            t = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=self.device)
            self._gather[key] = t
        return t

    def gather(self, G: torch.Tensor, sel: np.ndarray | None = None) -> torch.Tensor:
        """The modes of every target, or of the subset ``sel``: (C, m)."""
        idx = self.plan.gather_idx if sel is None else self.plan.gather_idx[sel]
        key = None if sel is None else ("sel", np.asarray(sel).tobytes())
        return G.reshape(G.shape[0], -1)[:, self._index(key, idx)]

    def gather_padded(self, G: torch.Tensor, sel_pad: np.ndarray) -> torch.Tensor:
        """Batched gather over the padded pair routing: G (P * nf2, nmy,
        nmx) pair-major, ``sel_pad`` (P, m_max) baseline indices; returns
        (P, nf2, m_max)."""
        P, m_max = sel_pad.shape
        flat = G.reshape(P, -1, int(np.prod(self.plan.nf)))
        idx = self._index(("pad", sel_pad.shape, sel_pad.tobytes()),
                          self.plan.gather_idx[sel_pad])
        return torch.gather(flat, 2, idx[:, None, :].expand(P, flat.shape[1], m_max))
