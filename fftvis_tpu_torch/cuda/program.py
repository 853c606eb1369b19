"""The simulation loop nest on the device.

The port of ``build_program`` (``fftvis_tpu/tpu/program.py``) without its
double-single and mesh paths: unpolarized (one feed) and polarized (two
feeds), one shared beam, per-antenna beams routed by beam pair, or an
eigenbeam basis (given ``beam_coefs``, or auto-rank's substitute for a
per-antenna list) contracted with its coefficients on the device, on the
direct, type-3 (2D, or low-rank z on a non-coplanar array) and type-1 (exact,
or ES on the fine grid) transforms, with or without horizon banding.
PyTorch runs eagerly, so the JAX package's ``lax.scan`` nest over (times,
freqs, source blocks) becomes Python loops over tensors:

    per time:   aberration + normalisation + rotation to topocentric,
                horizon mask, (az, za), transform coordinates (d = 2, or
                3 on a non-coplanar array)
      per freq:
        per source block of ``block`` (banded: per block active at this
        time):
                beam responses -> coherency rows x mask (C = P * nfeeds^2
                channels, pair-major) -> direct sum, spread into the fine
                grid (type-3, ES type-1) or add to the mode grid (exact
                type-1)
        after the blocks: FFT + deconvolution + interpolation (type-3),
                FFT + the deconvolved mode gather (ES type-1) or the mode
                gather (exact type-1), per pair or batched over the
                padded routing; flip conjugation without a feed swap, the
                reference's feed transpose, the inverse permutation of the
                pair routing; or the basis contraction

Ragged last blocks are simply shorter: eager tensors need no padding.

Horizon banding (``ProgramConfig.active``): the engine orders the catalog so
that sources visible together share blocks, and at time t only the blocks
that hold a source above the horizon run -- their beam rows, pre-phase and
spread or direct product. The JAX package needs two execution forms for
that (a scan over a static count of active blocks, and a per-time
compaction for type-3) because its shapes are static and its spread pays
an O(grid) fold a call; the loop here is dynamic and the spread accumulates
in place, so one form serves every path, and it skips each time's own
inactive blocks rather than the worst time's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..beams.eval import pair_index, pair_rows, response_channels
from ..beams.interface import stack_prepared
from ..coords.rotation import enu_to_az_za
from ..core.beams import BeamPairPlan
from ..nufft.direct import direct_type3, phasor
from .planning import SimPlan


class Basis:
    """The eigenbeam basis of a call, the ``use_basis`` branch of
    ``build_program`` (``fftvis_tpu/tpu/program.py``): channel pair p is
    eigenbeams (k, l) = ``kl_pairs[p]``, computed at every baseline, and
    :meth:`contract` weighs it by the antennas' coefficients. With ``sym``
    (the k <= l half-list) the (l, k) channel is the feed transpose of (k,
    l); ``flip_transpose`` marks the baselines whose result is
    feed-transposed (auto-rank's stand-in for the pair routing's flips), or
    is None. The index tensors go to ``device`` once."""

    def __init__(self, kl_pairs, sym: bool, bl_index: np.ndarray, flip_transpose, device):
        dev = torch.device(device)
        self.kl_pairs = tuple(tuple(p) for p in kl_pairs)
        self.sym = sym
        pairs = np.asarray(self.kl_pairs, dtype=np.int64).reshape(-1, 2)
        self.k, self.l = (torch.as_tensor(pairs[:, c].copy(), device=dev) for c in (0, 1))
        self.offdiag = torch.as_tensor(pairs[:, 0] != pairs[:, 1], device=dev)
        self.ant1, self.ant2 = (torch.as_tensor(bl_index[:, c].copy(), device=dev)
                                for c in (0, 1))
        self.transpose = None
        if flip_transpose is not None and flip_transpose.any():
            self.transpose = torch.tensor(flip_transpose, device=dev)

    def contract(self, per_pair, coefs, fi: int) -> torch.Tensor:
        """(P, nfeeds, nfeeds, nbl) channel visibilities -> (nbl, g, f)
        visibilities: ``sum_p conj(c[ant1, k_p]) c[ant2, l_p] V_p^T``, plus
        with ``sym`` the transposed (l, k) term of every off-diagonal pair,
        then the feed swap of the ``flip_transpose`` baselines. ``coefs``
        (nant, K, nfreq) on the device, in the output's dtype."""
        c = coefs[:, :, fi]
        c1, c2 = torch.conj(c[self.ant1]), c[self.ant2]  # (nbl, K)
        vis = torch.einsum("bp,pfgb->bgf", c1[:, self.k] * c2[:, self.l], per_pair)
        if self.sym:
            w_lk = c1[:, self.l] * c2[:, self.k] * self.offdiag
            vis = vis + torch.einsum("bp,pfgb->bfg", w_lk, per_pair)
        if self.transpose is not None:
            vis = torch.where(self.transpose[:, None, None], vis.transpose(1, 2), vis)
        return vis


class Routing:
    """The pair routing of baselines, the tables of ``build_program``
    (``fftvis_tpu/tpu/program.py``): pair p covers the baselines
    ``pair_plan.bls_idxs[p]``, concatenated in routing order and put back
    by ``inv_perm``. With ``pad`` every pair's list is padded to the
    longest, ``m_max``: ``sel_pad`` (P, m_max), ``flip_pad`` the padded
    flip flags and ``src_pos`` every baseline's slot in the (P * m_max)
    padded order; ``pair_i``, ``pair_j`` the pairs' beam indices (int32)
    and ``pair_index`` their per-beam index for ``pair_rows``' adjoint.
    With a :class:`Basis` (and no pair plan) the pairs are its eigenbeam
    pairs, every one at every baseline. Built on the host; the index
    tensors the device reads are copied to ``device`` once, and the engine
    keeps them across calls."""

    def __init__(self, pair_plan: BeamPairPlan | None, flipped: np.ndarray, pad: bool,
                 m_max: int, device, basis: Basis | None = None):
        self.pair_plan = pair_plan
        self.basis = basis
        self.pairs = list(basis.kl_pairs if basis is not None else pair_plan.pairs)
        self.npairs = len(self.pairs)
        self.pad = pad
        self.m_max = m_max
        nbl = flipped.size
        dev = torch.device(device)
        pi, pj = (torch.tensor([p[k] for p in self.pairs], dtype=torch.int32) for k in (0, 1))
        nbeams = 1 + max((max(p) for p in self.pairs), default=-1)
        self.pair_index = pair_index(pi, pj, nbeams).to(dev)
        self.pair_i, self.pair_j = pi.to(dev), pj.to(dev)
        self.flipped = torch.tensor(flipped, device=dev)
        self.inv_perm = None
        if basis is not None:
            return
        sel_concat = np.concatenate([np.asarray(s, dtype=np.int64) for s in pair_plan.bls_idxs])
        if not np.array_equal(sel_concat, np.arange(nbl)):
            inv_perm = np.empty(nbl, dtype=np.int64)
            inv_perm[sel_concat] = np.arange(nbl, dtype=np.int64)
            self.inv_perm = torch.as_tensor(inv_perm, device=dev)
        self.flip_p = [torch.as_tensor(flipped[s], device=dev) for s in pair_plan.bls_idxs]
        if pad:
            sel_pad = np.zeros((self.npairs, m_max), dtype=np.int64)
            sel_valid = np.zeros((self.npairs, m_max), dtype=bool)
            src_pos = np.empty(nbl, dtype=np.int64)
            for p, s in enumerate(pair_plan.bls_idxs):
                s = np.asarray(s, dtype=np.int64)
                sel_pad[p, : s.size] = s
                sel_valid[p, : s.size] = True
                src_pos[s] = p * m_max + np.arange(s.size)
            self.sel_pad = sel_pad
            self.flip_pad = torch.as_tensor(flipped[sel_pad] & sel_valid, device=dev)
            self.src_pos = torch.as_tensor(src_pos, device=dev)

    @property
    def multi(self) -> bool:
        """Whether pairs cover their own baselines (a basis computes every
        channel at every baseline)."""
        return self.basis is None and self.npairs > 1


class BlockRows:
    """One source block's beam responses and coherency rows, the JAX
    engine's ``source_block_weights``: ``(az, za, freq_value, freq_index,
    flux, mask) -> (P * nfeeds^2, B)`` complex rows times the mask,
    pair-major.

    - one pair of one beam (a shared beam): that beam's
      :meth:`~fftvis_tpu_torch.beams.interface.PreparedBeam.rows` (the
      fused ``beam_rows`` kernel for a tabulated beam);
    - same-grid tabulated beams: one ``beam_eval`` of the stacked table
      (:func:`~fftvis_tpu_torch.beams.interface.stack_prepared`), then the
      ``pair_rows`` kernel;
    - any other list (analytic and tabulated mixed): each beam's response,
      as channels, then ``pair_rows``.

    An eigenbeam basis runs the same way on its K eigenbeams and (k, l)
    pairs.
    """

    def __init__(self, prepared: list, routing: Routing, polarized: bool,
                 polarized_sky: bool, complex_dtype: torch.dtype):
        self.prepared = prepared
        self.polarized = polarized
        self.polarized_sky = polarized_sky
        self.complex_dtype = complex_dtype
        self.single = None
        self.stacked = None
        pairs = routing.pairs
        if len(pairs) == 1 and pairs[0][0] == pairs[0][1]:
            self.single = prepared[pairs[0][0]]
            return
        self.stacked = stack_prepared(prepared)
        self.pair_i, self.pair_j = routing.pair_i, routing.pair_j
        self.pair_index = routing.pair_index

    def __call__(self, az, za, freq_value: float, freq_index: int, flux, mask, table=None):
        """``table``, when given, replaces the stacked table (same layout)."""
        if self.single is not None:
            return self.single.rows(az, za, freq_value, freq_index, flux, mask,
                                    self.polarized_sky, self.complex_dtype)
        if self.stacked is not None:
            g = self.stacked.grid
            evals = self.stacked.channels(az, za, freq_index, table)
            ch_shape, is_power, feed = g.ch_shape, g.is_power, g.feed
        else:
            evals = torch.cat([
                response_channels(pb.evaluate(az, za, freq_value, freq_index), self.polarized)
                for pb in self.prepared
            ], dim=1)
            ch_shape, is_power, feed = ((2, 2, 2), False, 0) if self.polarized else ((1, 1), True, 0)
        rows = pair_rows(evals, self.pair_i, self.pair_j, flux, mask, ch_shape, is_power,
                         self.polarized_sky, feed, self.pair_index)
        return rows.to(self.complex_dtype)


@dataclass
class ProgramConfig:
    """What the loop nest reads besides its tensor inputs."""

    plan: SimPlan
    rows: BlockRows
    routing: Routing
    coord: torch.Tensor  # (d, 3) plan.coord_matrix on the device
    targets: object  # the direct path's device targets (device_tables), else None
    freqs: np.ndarray  # (nfreq,) host float64
    nbl: int
    block: int
    real_dtype: torch.dtype
    complex_dtype: torch.dtype
    polarized: bool = False
    # An eigenbeam basis's (nant, K, nfreq) coefficients on the device, in
    # complex_dtype; None without a basis.
    coefs: torch.Tensor | None = None
    # Horizon banding: per time, the indices of the source blocks to run
    # (host ints); None runs every block at every time.
    active: tuple | None = None
    # Float64 (coordinate matrix, mats, abvel, eq) on the device, from which
    # a float32 run forms its transform coordinates in float64: each path
    # reduces them to what it consumes (direct phases mod 2 pi, grid
    # coordinates mod nf, the exact type-1's cell and fraction, type-3's
    # pre-phase) before it casts to float32. None (a float64 run) forms them
    # from the inputs, in real_dtype.
    coord64: tuple | None = None

    @property
    def nfeeds(self) -> int:
        return 2 if self.polarized else 1


def device_tables(plan: SimPlan, pair_plan: BeamPairPlan | None, flipped: np.ndarray,
                  pad: bool, m_max: int, real_dtype: torch.dtype, device, basis=None):
    """What the loop reads besides the inputs, on ``device``, once a
    configuration: the :class:`Routing` (of ``basis``, the arguments of a
    :class:`Basis`, when given), the coordinate matrix and, on the direct
    path, the signed targets as the routing reads them -- (d, nbl); (d, P,
    m_max) padded; or one (d, m_p) a pair -- in float64 (the phases are
    formed in float64 at either precision), else None; d = 3 on a
    non-coplanar array."""
    dev = torch.device(device)
    r = Routing(pair_plan, flipped, pad, m_max, dev,
                basis=None if basis is None else Basis(*basis, dev))
    coord = torch.tensor(plan.coord_matrix, dtype=real_dtype, device=dev)
    targets = None
    if plan.mode == "direct":
        tg = torch.tensor(plan.targets, dtype=torch.float64, device=dev)
        if not r.multi:
            targets = tg
        elif r.pad:
            targets = tg[:, torch.as_tensor(r.sel_pad, device=dev)]
        else:
            targets = [tg[:, torch.as_tensor(s, device=dev)] for s in pair_plan.bls_idxs]
    return r, coord, targets


def _direct_block(cfg: ProgramConfig, acc, x, rows, targets):
    """One source block of the direct path into ``acc``: (C, nbl) for one
    pair, (P, nf2, m_max) batched over the padded routing, or a list of
    (nf2, m_p) per pair; ``targets`` from :func:`device_tables`, ``x``
    float64 at either precision (the phases are formed in float64 and, at
    float32, reduced mod 2 pi before the cast: :func:`~..nufft.direct.phasor`)."""
    r = cfg.routing
    if not r.multi:
        acc += direct_type3(x, rows, targets, source_block=x.shape[1])
        return acc
    nf2 = cfg.nfeeds**2
    if r.pad:
        e = phasor(torch.einsum("dpm,dn->pnm", targets, x), cfg.real_dtype)  # (P, n, m_max)
        acc += torch.bmm(rows.reshape(r.npairs, nf2, -1), e)
        return acc
    for p, tg in enumerate(targets):
        acc[p] += direct_type3(x, rows[p * nf2:(p + 1) * nf2], tg, source_block=x.shape[1])
    return acc


def _assemble(cfg: ProgramConfig, acc, fi: int) -> torch.Tensor:
    """One (time, freq)'s accumulator -> (nbl, g, f) visibilities: the
    transform's last steps, flip conjugation without a feed swap, the
    reference's feed transpose and the routing's inverse permutation; or a
    basis's contraction with the coefficients of frequency ``fi``."""
    plan, r, nf = cfg.plan, cfg.routing, cfg.nfeeds
    nf2 = nf * nf
    ex = plan.executor
    if not r.multi:
        if plan.mode == "type3":
            acc = ex.interpolate(ex.transform(acc))
        elif plan.mode == "type1":
            acc = ex.gather(ex.transform(acc))
        if r.basis is not None:  # no flips: every channel at every baseline
            return r.basis.contract(acc.reshape(r.npairs, nf, nf, cfg.nbl), cfg.coefs, fi)
        out = torch.where(r.flipped[None, :], torch.conj(acc), acc)
        return out.reshape(nf, nf, cfg.nbl).permute(2, 1, 0)
    if r.pad and plan.mode != "type3":
        # Batched over the padded routing: (P, nf2, m_max).
        out = acc if plan.mode == "direct" else ex.gather_padded(ex.transform(acc), r.sel_pad)
        out = torch.where(r.flip_pad[:, None, :], torch.conj(out), out)
        out = out.reshape(r.npairs, nf, nf, r.m_max).permute(0, 3, 2, 1)
        return out.reshape(r.npairs * r.m_max, nf, nf)[r.src_pos]
    if plan.mode == "direct":
        pair_outs = acc
    elif plan.mode == "type3":
        # Each pair reads its own channels (K z-modes each on a non-coplanar
        # array) of one grid: one interpolation node for all of them.
        pair_outs = ex.interpolate_pairs(ex.transform(acc), r.pair_plan.bls_idxs)
    else:
        G = ex.transform(acc)
        pair_outs = [ex.gather(G[p * nf2:(p + 1) * nf2], sel)
                     for p, sel in enumerate(r.pair_plan.bls_idxs)]
    vps = []
    for p, vp in enumerate(pair_outs):
        vp = torch.where(r.flip_p[p][None, :], torch.conj(vp), vp)
        vps.append(vp.reshape(nf, nf, -1).permute(2, 1, 0))
    vis = torch.cat(vps, dim=0)
    return vis if r.inv_perm is None else vis[r.inv_perm]


def run_program(cfg: ProgramConfig, mats, abvel, eq, coh, table=None) -> torch.Tensor:
    """Run the simulation on the device.

    mats (nt, 3, 3) ICRS->ENU rotations, abvel (nt, 3) aberration
    velocities, eq (3, nsrc) ICRS unit vectors, all in ``cfg.real_dtype``;
    coh the source coherency, (nsrc, nfreq) real for a Stokes-I sky or
    (nsrc, nfreq, 2, 2) complex for an IQUV sky; ``table``, when given, in
    place of the stacked beam table of a per-antenna list (same layout);
    all on one device, and only read (the engine keeps them across calls).
    Returns (nt, nfreq, nfeeds, nfeeds, nbl) complex visibilities on that
    device, feed axes already in the reference's transposed order.

    Differentiable in ``coh`` and ``table`` (``fftvis_tpu_torch.autodiff``):
    the kernels go through their autograd Functions where an input
    requires a gradient, the accumulators record their in-place adds, and
    the exact type-1 product runs out of place; without a gradient nothing
    more is allocated or launched.
    """
    plan, r = cfg.plan, cfg.routing
    dev = eq.device
    nt, nfreq, nsrc = mats.shape[0], cfg.freqs.size, eq.shape[1]
    nfeeds = cfg.nfeeds
    nf2 = nfeeds**2
    C = r.npairs * nf2
    # Grid channels: C, or C*K (c*K + k) on a non-coplanar array's type-3.
    CK = C * (plan.executor.channel_multiplier if plan.mode == "type3" else 1)
    coord, targets = cfg.coord, cfg.targets
    vis = torch.empty((nt, nfreq, nfeeds, nfeeds, cfg.nbl), dtype=cfg.complex_dtype,
                      device=dev)
    every_block = range(0, nsrc, cfg.block)

    for t in range(nt):
        eqa = eq + abvel[t][:, None]
        eqa = eqa / torch.linalg.norm(eqa, dim=0, keepdim=True)
        topo = mats[t] @ eqa  # (3, nsrc)
        mask = (topo[2] > 0).to(cfg.real_dtype)
        az, za = enu_to_az_za(topo[0], topo[1], orientation="uvbeam")
        # (d, nsrc) array-frame or lattice coordinates, float64 from the
        # float64 chain of a float32 run.
        if cfg.coord64 is None:
            xr = coord @ topo
        else:
            c64, m64, ab64, eq64 = cfg.coord64
            e64 = eq64 + ab64[t][:, None]
            xr = c64 @ (m64[t] @ (e64 / torch.linalg.norm(e64, dim=0, keepdim=True)))
        starts = (every_block if cfg.active is None
                  else [b * cfg.block for b in cfg.active[t]])

        for fi in range(nfreq):
            fv = float(cfg.freqs[fi])
            scale = plan.coord_scale(fv)
            flux_f = coh[:, fi]
            if plan.mode != "direct":
                acc = torch.zeros((CK,) + tuple(plan.executor.plan.nf),
                                  dtype=cfg.complex_dtype, device=dev)
            elif not r.multi:
                acc = torch.zeros((C, cfg.nbl), dtype=cfg.complex_dtype, device=dev)
            elif r.pad:
                acc = torch.zeros((r.npairs, nf2, r.m_max), dtype=cfg.complex_dtype,
                                  device=dev)
            else:
                acc = [torch.zeros((nf2, len(s)), dtype=cfg.complex_dtype, device=dev)
                       for s in r.pair_plan.bls_idxs]
            for b0 in starts:
                sl = slice(b0, b0 + cfg.block)
                rows = cfg.rows(az[sl], za[sl], fv, fi, flux_f[sl], mask[sl], table)
                x = xr[:, sl] * scale
                if plan.mode == "direct":
                    acc = _direct_block(cfg, acc, x, rows, targets)
                else:
                    acc = plan.executor.spread(x, rows, grid=acc)
            vis[t, fi] = _assemble(cfg, acc, fi).permute(1, 2, 0)
    return vis
