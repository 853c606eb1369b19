"""The CUDA simulation engine: host preparation, the device loop, assembly.

The port of the host half of ``TPUSimulationEngine._simulate_impl``
(``fftvis_tpu/tpu/engine.py``) for the slice: eps floor, baselines, horizon
cull, transform planning, source blocks, device inputs, and
``_assemble_output``'s (nfreq, ntimes, nbl) layout. The JAX engine's
program/plan/input caches, banding, pair routing, eigenbeams, meshes and
async fetch are later ROADMAP items; whatever the slice leaves out raises
``NotImplementedError`` instead of running another path.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..beams.interface import prepare_beam
from ..coords.rotation import SourceRotation
from ..core import coherency as coh_mod
from ..core import utils as core_utils
from ..core.beams import plan_beam_pairs
from ..core.simulate import SimulationEngine, default_accuracy_dict, resolve_precision
from .planning import plan_transform
from .program import ProgramConfig, run_program

logger = logging.getLogger(__name__)

# Sources per device block: one spread call (type-3) or one (block, nbl)
# phase matrix (direct) at a time.
SOURCE_BLOCK = 4096
# Bytes one direct-path block's complex phase matrix may take.
DIRECT_BLOCK_BYTES = 1 << 29

# CoordinateRotation kwargs the reference accepts; only include_aberration
# changes behaviour here (rotations are exact per time, no compaction).
_KNOWN_COORD_PARAMS = {
    "include_aberration", "update_bcrs_every", "source_buffer", "chunk_size",
}


def full_precision_matmuls() -> None:
    """float32 matmuls and convolutions in full float32, never TF32: the
    counterpart of the JAX engine's HIGHEST matmul precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class CUDASimulationEngine(SimulationEngine):
    """PyTorch visibility simulation engine (CUDA, or CPU for testing)."""

    def __init__(self, nufft_mode: str = "auto", device="cuda"):
        """Parameters
        ----------
        nufft_mode
            'auto' (cost-model selection), or force 'type3'/'direct'.
        device
            The torch device the loop runs on.
        """
        if nufft_mode not in ("auto", "type1", "type3", "direct"):
            raise ValueError(f"invalid nufft_mode {nufft_mode!r}")
        self.nufft_mode = nufft_mode
        self.device = torch.device(device)

    def simulate(
        self,
        ants: dict,
        freqs: np.ndarray,
        fluxes: np.ndarray,
        beam_list: list,
        ra: np.ndarray,
        dec: np.ndarray,
        times,
        telescope_loc,
        baselines: list | None = None,
        beam_idx: np.ndarray | None = None,
        precision: int = 2,
        polarized: bool = False,
        eps: float | None = None,
        upsample_factor=None,
        flat_array_tol: float = 1e-6,
        coord_method: str = "CoordinateRotationERFA",
        coord_method_params: dict | None = None,
        force_use_type3: bool = False,
        beam_coefs: np.ndarray | None = None,
    ) -> np.ndarray:
        if polarized:
            raise NotImplementedError("polarized simulation is ROADMAP item 6")
        if beam_coefs is not None:
            raise NotImplementedError("eigenbeam beam_coefs are ROADMAP item 7")
        if len(beam_list) != 1 or beam_idx is not None:
            raise NotImplementedError(
                "per-antenna beams (several beams or a beam_idx) are ROADMAP "
                "item 6"
            )
        coord_method_params = coord_method_params or {}
        unknown = set(coord_method_params) - _KNOWN_COORD_PARAMS
        if unknown:
            raise ValueError(
                f"unknown coord_method_params keys {sorted(unknown)}; known "
                f"keys are {sorted(_KNOWN_COORD_PARAMS)}"
            )
        full_precision_matmuls()

        freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
        real_dtype, complex_dtype = resolve_precision(precision)
        if eps is None:
            eps = default_accuracy_dict[precision]
        # An eps beyond the compute precision only inflates the kernel width.
        eps_floor = 5e-7 if real_dtype == torch.float32 else 1e-13
        if eps < eps_floor and eps != default_accuracy_dict[precision]:
            logger.warning(
                "requested NUFFT eps=%.1e is below what %s can resolve; "
                "using eps=%.1e", eps, real_dtype, eps_floor,
            )
        eps = max(eps, eps_floor)
        if upsample_factor is None:
            upsample_factor = 2

        if baselines is None:
            reds = core_utils.get_pos_reds(ants, include_autos=True)
            baselines = [red[0] for red in reds]
        nbl = len(baselines)
        pair_plan = plan_beam_pairs(list(ants), baselines, None)
        flipped_global = np.zeros(nbl, dtype=bool)
        for sel, fl in zip(pair_plan.bls_idxs, pair_plan.flipped):
            flipped_global[sel] = fl

        fluxes_arr = np.asarray(fluxes)
        polarized_sky = coh_mod.classify_sky(fluxes_arr, polarized_beam=False)

        rot = SourceRotation(
            ra, dec, times, telescope_loc, coord_method=coord_method,
            include_aberration=coord_method_params.get("include_aberration", True),
        )
        # Static horizon cull: sources below the horizon at every simulated
        # time are exact zeros; dropping them shrinks every device shape.
        src_keep = rot.cull_never_visible()
        if src_keep is not None:
            logger.info(
                "horizon culling: %d / %d sources never rise during the "
                "simulated times", src_keep.size - rot.nsrc, src_keep.size,
            )
        nsrc = rot.nsrc

        plan = plan_transform(
            self.nufft_mode, ants, baselines, freqs, eps, upsample_factor,
            flat_array_tol, force_use_type3, flipped_global, nbl, nsrc,
            nfeeds=1, npairs=pair_plan.npairs, device=self.device,
        )
        if plan.mode == "direct":
            block = max(1, min(SOURCE_BLOCK, DIRECT_BLOCK_BYTES // (16 * nbl)))
        else:
            block = SOURCE_BLOCK

        dev = self.device
        fl = fluxes_arr if src_keep is None else fluxes_arr[src_keep]
        coherency = coh_mod.build_coherency(fl, polarized_sky)
        abvel = rot.aberration if rot.aberration is not None else np.zeros((rot.ntimes, 3))
        cfg = ProgramConfig(
            plan=plan,
            beam=prepare_beam(beam_list[0]),
            freqs=freqs,
            nbl=nbl,
            block=block,
            real_dtype=real_dtype,
            complex_dtype=complex_dtype,
            flipped=torch.as_tensor(flipped_global, device=dev),
        )
        vis = run_program(
            cfg,
            torch.as_tensor(rot.matrices, dtype=real_dtype, device=dev),
            torch.as_tensor(abvel, dtype=real_dtype, device=dev),
            torch.as_tensor(rot.eq_vectors, dtype=real_dtype, device=dev),
            torch.as_tensor(coherency, dtype=real_dtype, device=dev),
        )
        return assemble_output(vis.cpu().numpy())


def assemble_output(vis: np.ndarray) -> np.ndarray:
    """(nt, nfreq, nbl) device output -> the reference layout
    (nfreq, nt, nbl), C-contiguous (ref cpu_simulate.py:849-854)."""
    return np.ascontiguousarray(np.transpose(vis, (1, 0, 2)))
