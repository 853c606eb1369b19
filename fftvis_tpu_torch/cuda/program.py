"""The simulation loop nest on the device.

The port of ``build_program`` (``fftvis_tpu/tpu/program.py``) without its
eigenbeam basis, double-single, banding and mesh paths: unpolarized (one
feed) and polarized (two feeds), one shared beam or per-antenna beams
routed by beam pair, on the direct, type-3 and exact type-1 transforms.
PyTorch runs eagerly, so the JAX package's ``lax.scan`` nest over (times,
freqs, source blocks) becomes Python loops over tensors:

    per time:   aberration + normalisation + rotation to topocentric,
                horizon mask, (az, za), transform coordinates
      per freq:
        per source block of ``block``:
                beam responses -> coherency rows x mask (C = P * nfeeds^2
                channels, pair-major) -> direct sum, spread into the fine
                grid (type-3) or add to the mode grid (type-1)
        after the blocks: FFT + deconvolution + interpolation (type-3) or
                the mode gather (type-1), per pair or batched over the
                padded routing; flip conjugation without a feed swap, the
                reference's feed transpose, the inverse permutation of the
                pair routing

Ragged last blocks are simply shorter: eager tensors need no padding.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..beams.eval import pair_rows, response_channels
from ..beams.interface import stack_prepared
from ..coords.rotation import enu_to_az_za
from ..core.beams import BeamPairPlan
from ..nufft.direct import direct_type3
from .planning import SimPlan


class Routing:
    """The pair routing of baselines, the tables of ``build_program``
    (``fftvis_tpu/tpu/program.py``): pair p covers the baselines
    ``pair_plan.bls_idxs[p]``, concatenated in routing order and put back
    by ``inv_perm``. With ``pad`` every pair's list is padded to the
    longest, ``m_max``: ``sel_pad`` (P, m_max), ``flip_pad`` the padded
    flip flags and ``src_pos`` every baseline's slot in the (P * m_max)
    padded order; ``pair_i``, ``pair_j`` the pairs' beam indices (int32).
    Built on the host; the index tensors the device reads are copied to
    ``device`` once, and the engine keeps them across calls."""

    def __init__(self, pair_plan: BeamPairPlan, flipped: np.ndarray, pad: bool,
                 m_max: int, device):
        self.pair_plan = pair_plan
        self.npairs = pair_plan.npairs
        self.pad = pad
        self.m_max = m_max
        nbl = flipped.size
        dev = torch.device(device)
        self.pair_i, self.pair_j = (
            torch.tensor([p[k] for p in pair_plan.pairs], dtype=torch.int32, device=dev)
            for k in (0, 1))
        self.flipped = torch.tensor(flipped, device=dev)
        sel_concat = np.concatenate([np.asarray(s, dtype=np.int64) for s in pair_plan.bls_idxs])
        self.inv_perm = None
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
        return self.npairs > 1


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
    """

    def __init__(self, prepared: list, routing: Routing, polarized: bool,
                 polarized_sky: bool, complex_dtype: torch.dtype):
        self.prepared = prepared
        self.polarized = polarized
        self.polarized_sky = polarized_sky
        self.complex_dtype = complex_dtype
        self.single = None
        self.stacked = None
        pairs = routing.pair_plan.pairs
        if len(pairs) == 1 and pairs[0][0] == pairs[0][1]:
            self.single = prepared[pairs[0][0]]
            return
        self.stacked = stack_prepared(prepared)
        self.pair_i, self.pair_j = routing.pair_i, routing.pair_j

    def __call__(self, az, za, freq_value: float, freq_index: int, flux, mask):
        if self.single is not None:
            return self.single.rows(az, za, freq_value, freq_index, flux, mask,
                                    self.polarized_sky, self.complex_dtype)
        if self.stacked is not None:
            g = self.stacked.grid
            evals = self.stacked.channels(az, za, freq_index)
            ch_shape, is_power, feed = g.ch_shape, g.is_power, g.feed
        else:
            evals = torch.cat([
                response_channels(pb.evaluate(az, za, freq_value, freq_index), self.polarized)
                for pb in self.prepared
            ], dim=1)
            ch_shape, is_power, feed = ((2, 2, 2), False, 0) if self.polarized else ((1, 1), True, 0)
        rows = pair_rows(evals, self.pair_i, self.pair_j, flux, mask, ch_shape, is_power,
                         self.polarized_sky, feed)
        return rows.to(self.complex_dtype)


@dataclass
class ProgramConfig:
    """What the loop nest reads besides its tensor inputs."""

    plan: SimPlan
    rows: BlockRows
    routing: Routing
    coord: torch.Tensor  # (2, 3) plan.coord_matrix on the device
    targets: object  # the direct path's device targets (device_tables), else None
    freqs: np.ndarray  # (nfreq,) host float64
    nbl: int
    block: int
    real_dtype: torch.dtype
    complex_dtype: torch.dtype
    polarized: bool = False

    @property
    def nfeeds(self) -> int:
        return 2 if self.polarized else 1


def device_tables(plan: SimPlan, pair_plan: BeamPairPlan, flipped: np.ndarray, pad: bool,
                  m_max: int, real_dtype: torch.dtype, device):
    """What the loop reads besides the inputs, on ``device``, once a
    configuration: the :class:`Routing`, the coordinate matrix and, on the
    direct path, the signed targets as the routing reads them -- (d, nbl);
    (d, P, m_max) padded; or one (d, m_p) a pair -- else None."""
    dev = torch.device(device)
    r = Routing(pair_plan, flipped, pad, m_max, dev)
    coord = torch.tensor(plan.coord_matrix, dtype=real_dtype, device=dev)
    targets = None
    if plan.mode == "direct":
        tg = torch.tensor(plan.targets, dtype=real_dtype, device=dev)
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
    (nf2, m_p) per pair; ``targets`` from :func:`_direct_targets`."""
    r = cfg.routing
    if not r.multi:
        acc += direct_type3(x, rows, targets, source_block=x.shape[1])
        return acc
    nf2 = cfg.nfeeds**2
    if r.pad:
        phase = torch.einsum("dpm,dn->pnm", targets, x)
        e = torch.complex(torch.cos(phase), torch.sin(phase))  # (P, n, m_max)
        acc += torch.bmm(rows.reshape(r.npairs, nf2, -1), e)
        return acc
    for p, tg in enumerate(targets):
        acc[p] += direct_type3(x, rows[p * nf2:(p + 1) * nf2], tg, source_block=x.shape[1])
    return acc


def _assemble(cfg: ProgramConfig, acc) -> torch.Tensor:
    """One (time, freq)'s accumulator -> (nbl, g, f) visibilities: the
    transform's last steps, flip conjugation without a feed swap, the
    reference's feed transpose and the routing's inverse permutation."""
    plan, r, nf = cfg.plan, cfg.routing, cfg.nfeeds
    nf2 = nf * nf
    ex = plan.executor
    if not r.multi:
        if plan.mode == "type3":
            acc = ex.interpolate(ex.transform(acc))
        elif plan.mode == "type1":
            acc = ex.gather(ex.transform(acc))
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
    else:
        G = ex.transform(acc)
        get = ex.interpolate if plan.mode == "type3" else ex.gather
        pair_outs = [get(G[p * nf2:(p + 1) * nf2], sel)
                     for p, sel in enumerate(r.pair_plan.bls_idxs)]
    vps = []
    for p, vp in enumerate(pair_outs):
        vp = torch.where(r.flip_p[p][None, :], torch.conj(vp), vp)
        vps.append(vp.reshape(nf, nf, -1).permute(2, 1, 0))
    vis = torch.cat(vps, dim=0)
    return vis if r.inv_perm is None else vis[r.inv_perm]


def run_program(cfg: ProgramConfig, mats, abvel, eq, coh) -> torch.Tensor:
    """Run the simulation on the device.

    mats (nt, 3, 3) ICRS->ENU rotations, abvel (nt, 3) aberration
    velocities, eq (3, nsrc) ICRS unit vectors, all in ``cfg.real_dtype``;
    coh the source coherency, (nsrc, nfreq) real for a Stokes-I sky or
    (nsrc, nfreq, 2, 2) complex for an IQUV sky; all on one device, and
    only read (the engine keeps them across calls). Returns (nt, nfreq,
    nfeeds, nfeeds, nbl) complex visibilities on that device, feed axes
    already in the reference's transposed order.
    """
    plan, r = cfg.plan, cfg.routing
    dev = eq.device
    nt, nfreq, nsrc = mats.shape[0], cfg.freqs.size, eq.shape[1]
    nfeeds = cfg.nfeeds
    nf2 = nfeeds**2
    C = r.npairs * nf2
    coord, targets = cfg.coord, cfg.targets
    vis = torch.empty((nt, nfreq, nfeeds, nfeeds, cfg.nbl), dtype=cfg.complex_dtype,
                      device=dev)

    for t in range(nt):
        eqa = eq + abvel[t][:, None]
        eqa = eqa / torch.linalg.norm(eqa, dim=0, keepdim=True)
        topo = mats[t] @ eqa  # (3, nsrc)
        mask = (topo[2] > 0).to(cfg.real_dtype)
        az, za = enu_to_az_za(topo[0], topo[1], orientation="uvbeam")
        xr = coord @ topo  # (2, nsrc) array-plane or lattice coordinates

        for fi in range(nfreq):
            fv = float(cfg.freqs[fi])
            scale = plan.coord_scale(fv)
            flux_f = coh[:, fi]
            if plan.mode != "direct":
                acc = torch.zeros((C,) + tuple(plan.executor.plan.nf),
                                  dtype=cfg.complex_dtype, device=dev)
            elif not r.multi:
                acc = torch.zeros((C, cfg.nbl), dtype=cfg.complex_dtype, device=dev)
            elif r.pad:
                acc = torch.zeros((r.npairs, nf2, r.m_max), dtype=cfg.complex_dtype,
                                  device=dev)
            else:
                acc = [torch.zeros((nf2, len(s)), dtype=cfg.complex_dtype, device=dev)
                       for s in r.pair_plan.bls_idxs]
            for b0 in range(0, nsrc, cfg.block):
                sl = slice(b0, b0 + cfg.block)
                rows = cfg.rows(az[sl], za[sl], fv, fi, flux_f[sl], mask[sl])
                x = xr[:, sl] * scale
                if plan.mode == "direct":
                    acc = _direct_block(cfg, acc, x, rows, targets)
                else:
                    plan.executor.spread(x, rows, grid=acc)
            vis[t, fi] = _assemble(cfg, acc).permute(1, 2, 0)
    return vis
