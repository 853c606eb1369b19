"""The simulation loop nest on the device.

The port of the single-beam-pair path of ``build_program``
(``fftvis_tpu/tpu/program.py``). PyTorch runs eagerly, so the JAX
package's ``lax.scan`` nest over (times, freqs, source blocks) becomes
Python loops over tensors:

    per time:   aberration + normalisation + rotation to topocentric,
                horizon mask, (az, za)
      per freq:
        per source block of ``block``:
                beam power -> coherency rows x mask -> transform coords ->
                spread into the fine grid (type-3) or direct sum
        after the blocks: FFT + deconvolution + interpolation (type-3),
                flip conjugation

Ragged last blocks are simply shorter: eager tensors need no padding.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..beams.interface import PreparedBeam
from ..coords.rotation import enu_to_az_za
from ..core.coherency import apparent_coherency_rows
from ..core.utils import speed_of_light
from ..nufft.direct import direct_type3
from .planning import SimPlan

TWO_PI = 2.0 * np.pi


@dataclass
class ProgramConfig:
    """What the loop nest reads besides its tensor inputs."""

    plan: SimPlan
    beam: PreparedBeam
    freqs: np.ndarray  # (nfreq,) host float64
    nbl: int
    block: int
    real_dtype: torch.dtype
    complex_dtype: torch.dtype
    flipped: torch.Tensor  # (nbl,) bool on the device


def run_program(cfg: ProgramConfig, mats, abvel, eq, coh) -> torch.Tensor:
    """Run the simulation on the device.

    mats (nt, 3, 3) ICRS->ENU rotations, abvel (nt, 3) aberration
    velocities, eq (3, nsrc) ICRS unit vectors, coh (nsrc, nfreq) real
    coherency -- all in ``cfg.real_dtype`` on one device. Returns
    (nt, nfreq, nbl) complex visibilities on that device.
    """
    plan = cfg.plan
    dev = eq.device
    nt, nfreq, nsrc = mats.shape[0], cfg.freqs.size, eq.shape[1]
    rotation = torch.as_tensor(plan.rotation_matrix[:2], dtype=cfg.real_dtype,
                               device=dev)
    if plan.mode == "direct":
        targets = torch.as_tensor(plan.targets, dtype=cfg.real_dtype, device=dev)
    vis = torch.empty((nt, nfreq, cfg.nbl), dtype=cfg.complex_dtype, device=dev)

    for t in range(nt):
        eqa = eq + abvel[t][:, None]
        eqa = eqa / torch.linalg.norm(eqa, dim=0, keepdim=True)
        topo = mats[t] @ eqa  # (3, nsrc)
        mask = (topo[2] > 0).to(cfg.real_dtype)
        az, za = enu_to_az_za(topo[0], topo[1], orientation="uvbeam")
        xr = rotation @ topo  # (2, nsrc) array-plane coordinates

        for fi in range(nfreq):
            fv = float(cfg.freqs[fi])
            scale = TWO_PI * fv / speed_of_light
            flux_f = coh[:, fi]
            if plan.mode == "direct":
                acc = torch.zeros((1, cfg.nbl), dtype=cfg.complex_dtype, device=dev)
            else:
                acc = torch.zeros((1,) + tuple(plan.executor.plan.nf),
                                  dtype=cfg.complex_dtype, device=dev)
            for b0 in range(0, nsrc, cfg.block):
                sl = slice(b0, b0 + cfg.block)
                power = cfg.beam.evaluate(az[sl], za[sl], fv, fi)
                rows = apparent_coherency_rows(power, power, flux_f[sl])
                rows = rows * mask[sl][None, :]
                x = xr[:, sl] * scale
                if plan.mode == "direct":
                    acc += direct_type3(x, rows, targets, source_block=cfg.block)
                else:
                    plan.executor.spread(x, rows, grid=acc)
            if plan.mode == "type3":
                acc = plan.executor.interpolate(plan.executor.transform(acc))
            out = torch.where(cfg.flipped[None, :], torch.conj(acc), acc)
            vis[t, fi] = out[0]
    return vis
