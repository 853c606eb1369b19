"""The CUDA simulation engine: host preparation, the device loop, assembly.

The port of the host half of ``TPUSimulationEngine._simulate_impl``
(``fftvis_tpu/tpu/engine.py``): eps floor, baselines, the antenna-to-beam
mapping and its beam-pair routing (one shared beam, or per-antenna beams
with ``beam_idx``), horizon cull, transform planning, source blocks, beam
preparation, device inputs, and ``_assemble_output``'s layout: (nfreq,
ntimes, nbl), or (nfreq, ntimes, nfeeds, nfeeds, nbl) when polarized. The
JAX engine's program/plan/input caches, banding, eigenbeams (given
``beam_coefs``, or its auto-rank substitution of a per-antenna list),
meshes and async fetch are later ROADMAP items; a per-antenna list runs the
exact pair routing, the reference's semantics. Whatever the port leaves out
raises ``NotImplementedError`` instead of running another path.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..beams.interface import prepare_beams
from ..coords.rotation import SourceRotation
from ..core import coherency as coh_mod
from ..core import utils as core_utils
from ..core.beams import plan_beam_pairs
from ..core.simulate import SimulationEngine, default_accuracy_dict, resolve_precision
from .planning import plan_transform
from .program import BlockRows, ProgramConfig, Routing, run_program

logger = logging.getLogger(__name__)

# Sources per device block: one spread call (type-3), one mode-grid
# product (type-1) or one (block, nbl) phase matrix (direct) at a time.
SOURCE_BLOCK = 4096
# Bytes one direct-path block's complex phase matrix may take.
DIRECT_BLOCK_BYTES = 1 << 29
# Bytes one type-1/type-3 block's coherency rows and transform temporaries
# may take.
BLOCK_BYTES = 1 << 30

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
        beam_spline_opts: dict | None = None,
        flat_array_tol: float = 1e-6,
        interpolation_function: str = "az_za_map_coordinates",
        coord_method: str = "CoordinateRotationERFA",
        coord_method_params: dict | None = None,
        force_use_type3: bool = False,
        beam_coefs: np.ndarray | None = None,
    ) -> np.ndarray:
        if beam_coefs is not None:
            raise NotImplementedError("eigenbeam beam_coefs are ROADMAP item 7")
        beam_idx = core_utils.validate_beam_idx(beam_idx, beam_coefs, len(beam_list),
                                                len(ants))
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
        pair_plan = plan_beam_pairs(list(ants), baselines, beam_idx)
        flipped_global = np.zeros(nbl, dtype=bool)
        for sel, fl in zip(pair_plan.bls_idxs, pair_plan.flipped):
            flipped_global[sel] = fl
        pad_routing, m_max = pair_routing(pair_plan, nbl)

        fluxes_arr = np.asarray(fluxes)
        polarized_sky = coh_mod.classify_sky(fluxes_arr, polarized_beam=polarized)
        nfeeds = 2 if polarized else 1

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
            nfeeds=nfeeds, npairs=pair_plan.npairs, device=self.device,
        )
        C = pair_plan.npairs * nfeeds**2
        block = source_block(plan, C, nbl, pair_plan.npairs, pad_routing, m_max,
                             complex_dtype)
        dev = self.device
        if plan.mode == "type3":
            # The fine grid of every channel, and the FFT's output beside it.
            grid_bytes = C * int(np.prod(plan.executor.plan.nf)) * complex_dtype.itemsize
            check_device_memory(2 * grid_bytes, f"the type-3 grids ({C} channels of "
                                f"{plan.executor.plan.nf})", dev)

        fl = fluxes_arr if src_keep is None else fluxes_arr[src_keep]
        coherency = coh_mod.build_coherency(fl, polarized_sky)
        coh_dtype = complex_dtype if polarized_sky else real_dtype
        abvel = rot.aberration if rot.aberration is not None else np.zeros((rot.ntimes, 3))
        prepared = prepare_beams(
            beam_list, freqs, polarized, spline_opts=beam_spline_opts,
            interpolation_function=interpolation_function, dtype=real_dtype, device=dev,
        )
        cfg = ProgramConfig(
            plan=plan,
            rows=BlockRows(prepared, pair_plan.pairs, polarized, polarized_sky,
                           complex_dtype, dev),
            routing=Routing(pair_plan, flipped_global, pad_routing, m_max, dev),
            freqs=freqs,
            nbl=nbl,
            block=block,
            real_dtype=real_dtype,
            complex_dtype=complex_dtype,
            polarized=polarized,
        )
        vis = run_program(
            cfg,
            torch.as_tensor(rot.matrices, dtype=real_dtype, device=dev),
            torch.as_tensor(abvel, dtype=real_dtype, device=dev),
            torch.as_tensor(rot.eq_vectors, dtype=real_dtype, device=dev),
            torch.as_tensor(coherency, dtype=coh_dtype, device=dev),
        )
        return assemble_output(vis.cpu().numpy(), polarized)


def pair_routing(pair_plan, nbl: int) -> tuple[bool, int]:
    """(pad_routing, m_max): whether the pair routing pads every pair's
    baseline list to the longest, m_max, and batches over pairs (the JAX
    engine's rule: when the padding wastes at most 4x, or beyond 32 pairs),
    or loops over pairs."""
    if pair_plan.npairs <= 1:
        return False, 0
    m_max = max(len(s) for s in pair_plan.bls_idxs)
    return bool(pair_plan.npairs * m_max <= 4 * nbl or pair_plan.npairs > 32), m_max


def source_block(plan, C: int, nbl: int, npairs: int, pad_routing: bool, m_max: int,
                 complex_dtype: torch.dtype) -> int:
    """Sources a device block: at most :data:`SOURCE_BLOCK`, and fewer where
    a block's temporaries would pass their budget -- the direct path's
    (block, baselines) phase matrix (padded to npairs * m_max with the
    padded routing), or a transform's (C, block) rows (twice: the rows and
    their pre-phased copy) plus the exact type-1's (block, nmy * nmx)
    outer factor."""
    if plan.mode == "direct":
        eff_bl = npairs * m_max if pad_routing else nbl
        return max(1, min(SOURCE_BLOCK, DIRECT_BLOCK_BYTES // (16 * eff_bl)))
    per_source = 2 * C * complex_dtype.itemsize
    if plan.mode == "type1":
        per_source += int(np.prod(plan.executor.plan.nf)) * complex_dtype.itemsize
    return max(1, min(SOURCE_BLOCK, BLOCK_BYTES // per_source))


def check_device_memory(nbytes: int, what: str, device) -> None:
    """Raise a clear ``MemoryError`` before allocating ``nbytes`` on a CUDA
    device that has less free, rather than let the allocator fail in the
    loop."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    free, total = torch.cuda.mem_get_info(device)
    if nbytes > free:
        raise MemoryError(
            f"{what} need {nbytes / 2**30:.2f} GiB on {device}, which has "
            f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free; simulate "
            "fewer beam pairs (or frequencies) a call"
        )


def assemble_output(vis: np.ndarray, polarized: bool) -> np.ndarray:
    """(nt, nfreq, nfeeds, nfeeds, nbl) device output -> the reference
    layout, C-contiguous (ref cpu_simulate.py:849-854): polarized
    (nfreq, nt, nfeeds, nfeeds, nbl), else (nfreq, nt, nbl)."""
    vis = np.transpose(vis, (1, 0, 2, 3, 4))
    return np.ascontiguousarray(vis if polarized else vis[:, :, 0, 0, :])
