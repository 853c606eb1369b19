"""The CUDA simulation engine: host preparation, the device loop, assembly.

The port of ``TPUSimulationEngine`` (``fftvis_tpu/tpu/engine.py``): eps
floor, baselines, the antenna-to-beam mapping and its beam-pair routing (one
shared beam, or per-antenna beams with ``beam_idx``), horizon cull,
transform planning, source blocks, beam preparation, device inputs, and
``_assemble_output``'s layout: (nfreq, ntimes, nbl), or (nfreq, ntimes,
nfeeds, nfeeds, nbl) when polarized.

Its host layer keeps what a sweep of calls on one configuration shares, each
cache keyed on the content of everything that changes its entries:

- :data:`PLAN_CACHE`, the JAX engine's ``_PLAN_CACHE``: redundant groups,
  the baseline index, the culled rotation (a shallow copy a call), the pair
  plan and the transform plan -- whose executor holds its device tables, so
  its key takes the device, the real dtype and ``FFTVIS_TYPE1`` too;
- :data:`PROGRAM_CACHE`: the device routing tables, the coordinate matrix
  and the direct path's targets;
- :data:`INPUT_CACHE`, the JAX ``_INPUT_CACHE``: the device inputs;
- the prepared-beam and stacked-table caches of ``beams/interface.py``.

A call hashes each user array at most once (``consistent_inputs``), enqueues
the device loop and the copy of its output into pinned host memory, and
returns a :class:`VisibilityFuture` (``async_fetch``) or its result.
``nchunks`` caps the source block at ``ceil(nsrc / nchunks)``. The JAX
engine's banding, eigenbeams (given ``beam_coefs``, or its auto-rank
substitution of a per-antenna list) and meshes are later ROADMAP items; a
per-antenna list runs the exact pair routing, the reference's semantics.
Whatever the port leaves out raises ``NotImplementedError`` instead of
running another path.
"""

from __future__ import annotations

import copy
import functools
import logging
import os
import threading

import numpy as np
import torch

from ..beams import interface
from ..beams.interface import prepare_beams
from ..coords.erfa_lite import TelescopeLocation, times_to_jd
from ..coords.rotation import SourceRotation
from ..core import coherency as coh_mod
from ..core import utils as core_utils
from ..core.beams import plan_beam_pairs
from ..core.hashing import LRUCache, consistent_inputs, hash_parts
from ..core.simulate import SimulationEngine, default_accuracy_dict, resolve_precision
from .planning import plan_transform
from .program import BlockRows, ProgramConfig, device_tables, run_program

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

# Host plans, device program tables and device inputs across calls (LRU).
PLAN_CACHE = LRUCache(16)
PROGRAM_CACHE = LRUCache(16)
INPUT_CACHE = LRUCache(32)


def _caches() -> dict:
    return {"plan": PLAN_CACHE, "program": PROGRAM_CACHE, "input": INPUT_CACHE,
            "prepared": interface.PREPARED_CACHE, "stack": interface.STACK_CACHE}


def cache_stats() -> dict:
    """{cache: (hits, misses)} of the engine's and the beam layer's caches
    since they were last cleared."""
    return {name: (c.hits, c.misses) for name, c in _caches().items()}


def clear_caches() -> None:
    """Empty every cache and zero its counts (the next call is cold)."""
    for c in _caches().values():
        c.clear()


def full_precision_matmuls() -> None:
    """float32 matmuls and convolutions in full float32, never TF32: the
    counterpart of the JAX engine's HIGHEST matmul precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class VisibilityFuture:
    """Handle to an in-flight simulation (``async_fetch=True``).

    The device loop has been enqueued and the copy of its output into a
    pinned host buffer started on the call's stream, behind an event;
    ``result()`` waits for the event and assembles the visibility array.
    Several simulations dispatched before any result is collected overlap
    each call's host work with the card's work on the others.
    ``np.asarray(future)`` is ``future.result()``.
    """

    def __init__(self, dev, host, event, assemble):
        self._dev = dev  # the device output, held until its copy is waited for
        self._host = host
        self._event = event
        self._assemble = assemble
        self._result = None
        # result() may be called on one future from several threads: the
        # lock lets one of them assemble and hands the others its array.
        self._lock = threading.Lock()

    @classmethod
    def from_result(cls, value: np.ndarray) -> "VisibilityFuture":
        """An already-resolved future (a CPU device has nothing to defer)."""
        fut = cls(None, None, None, None)
        fut._result = value
        return fut

    def done(self) -> bool:
        """True when the device work and the copy to the host have finished."""
        event = self._event  # read once: result() may drop it meanwhile
        return event is None or event.query()

    def result(self) -> np.ndarray:
        with self._lock:
            if self._result is None:
                self._event.synchronize()
                self._result = self._assemble(self._host.numpy())
                # The device output, the pinned buffer and the assembly
                # closure are no longer needed.
                self._dev = self._host = self._event = self._assemble = None
        return self._result

    def __array__(self, dtype=None, copy=None):
        res = self.result()
        out = res if dtype is None else res.astype(dtype, copy=False)
        if copy and out is res:
            # NumPy 2 semantics: copy=True must not alias the memoized
            # result (callers may mutate the returned array in place).
            out = res.copy()
        elif copy is False and out is not res:
            raise ValueError("dtype conversion requires a copy (copy=False requested)")
        return out


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

    def simulate(self, *args, async_fetch: bool = False, **kwargs):
        """Simulate visibilities (the arguments of :meth:`_dispatch`).
        Returns the array, or with ``async_fetch`` a
        :class:`VisibilityFuture`."""
        # One call is single-threaded and never mutates its input arrays
        # midway: each hashed array is checked at most once.
        with consistent_inputs():
            fut = self._dispatch(*args, **kwargs)
        return fut if async_fetch else fut.result()

    def _dispatch(
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
        nchunks: int = 1,
    ) -> VisibilityFuture:
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
        dev = self.device

        antnums = list(ants)
        antpos = np.array([np.asarray(ants[a], dtype=float) for a in antnums])
        if baselines is None:
            rkey = hash_parts(("reds-v1", tuple(map(repr, antnums)), antpos))
            baselines = PLAN_CACHE.get_or_build(rkey, lambda: [
                red[0] for red in core_utils.get_pos_reds(ants, include_autos=True)])
        nbl = len(baselines)
        bl_index = _baseline_index(antnums, baselines)
        pp_key = hash_parts(("pairs-v1", tuple(map(repr, antnums)), bl_index,
                             None if beam_idx is None else np.asarray(beam_idx)))
        pair_plan, flipped_global = PLAN_CACHE.get_or_build(
            pp_key, lambda: _pair_plan(antnums, baselines, beam_idx, nbl))
        pad_routing, m_max = pair_routing(pair_plan, nbl)

        fluxes_arr = np.asarray(fluxes)
        polarized_sky = coh_mod.classify_sky(fluxes_arr, polarized_beam=polarized)
        nfeeds = 2 if polarized else 1

        include_ab = coord_method_params.get("include_aberration", True)
        rot_key = hash_parts((
            "rot-v1", np.asarray(ra), np.asarray(dec), times_to_jd(times),
            repr(TelescopeLocation.from_any(telescope_loc)), coord_method, bool(include_ab),
        ))
        rot, src_keep = PLAN_CACHE.get_or_build(rot_key, lambda: _culled_rotation(
            ra, dec, times, telescope_loc, coord_method, include_ab))
        rot = copy.copy(rot)  # later stages may re-assign, never the cached one
        nsrc = rot.nsrc

        plan_key = hash_parts((
            "plan-v1", antpos, bl_index, float(np.max(freqs)), float(eps),
            float(upsample_factor), float(flat_array_tol), bool(force_use_type3),
            flipped_global, nsrc, nfeeds, pair_plan.npairs, self.nufft_mode,
            str(dev), str(real_dtype), os.environ.get("FFTVIS_TYPE1", "auto"),
        ))
        plan = PLAN_CACHE.get_or_build(plan_key, lambda: plan_transform(
            self.nufft_mode, ants, baselines, freqs, eps, upsample_factor,
            flat_array_tol, force_use_type3, flipped_global, nbl, nsrc,
            nfeeds=nfeeds, npairs=pair_plan.npairs, device=dev,
        ))
        C = pair_plan.npairs * nfeeds**2
        nchunks = max(1, min(int(nchunks), nsrc))
        block = min(source_block(plan, C, nbl, pair_plan.npairs, pad_routing, m_max,
                                 complex_dtype), -(-nsrc // nchunks))
        if plan.mode == "type3":
            # The fine grid of every channel, and the FFT's output beside it.
            grid_bytes = C * int(np.prod(plan.executor.plan.nf)) * complex_dtype.itemsize
            check_device_memory(2 * grid_bytes, f"the type-3 grids ({C} channels of "
                                f"{plan.executor.plan.nf})", dev)

        prepared = prepare_beams(
            beam_list, freqs, polarized, spline_opts=beam_spline_opts,
            interpolation_function=interpolation_function, dtype=real_dtype, device=dev,
        )
        # plan_key holds the device and the dtype.
        routing, coord, targets = PROGRAM_CACHE.get_or_build(
            hash_parts(("program-v1", plan_key, pp_key)),
            lambda: device_tables(plan, pair_plan, flipped_global, pad_routing, m_max,
                                  real_dtype, dev))
        cfg = ProgramConfig(
            plan=plan,
            rows=BlockRows(prepared, routing, polarized, polarized_sky, complex_dtype),
            routing=routing,
            coord=coord,
            targets=targets,
            freqs=freqs,
            nbl=nbl,
            block=block,
            real_dtype=real_dtype,
            complex_dtype=complex_dtype,
            polarized=polarized,
        )

        def upload(key_parts, build, dtype):
            key = hash_parts(key_parts + (str(dtype), str(dev)))
            return INPUT_CACHE.get_or_build(
                key, lambda: torch.tensor(build(), dtype=dtype, device=dev))

        abvel = upload(("abvel", rot.aberration, rot.ntimes), lambda: (
            rot.aberration if rot.aberration is not None else np.zeros((rot.ntimes, 3))),
            real_dtype)
        coh = upload(
            ("coh", fluxes_arr, src_keep, polarized_sky),
            lambda: coh_mod.build_coherency(
                fluxes_arr if src_keep is None else fluxes_arr[src_keep], polarized_sky),
            complex_dtype if polarized_sky else real_dtype)
        vis = run_program(
            cfg,
            upload(("mats", rot.matrices), lambda: rot.matrices, real_dtype),
            abvel,
            upload(("eq", rot.eq_vectors), lambda: rot.eq_vectors, real_dtype),
            coh,
        )
        return fetch(vis, polarized)


def _baseline_index(antnums: list, baselines) -> np.ndarray:
    """(nbl, 2) antenna indices of the baselines, frozen and kept by the
    content of (antnums, baselines), so it keeps one identity across calls
    and its digest is taken once."""
    key = (tuple(antnums), tuple(baselines))
    try:
        hit = PLAN_CACHE.get(key)
    except TypeError:  # ndarray or list elements are unhashable
        key = (tuple(antnums), tuple((b[0], b[1]) for b in baselines))
        hit = PLAN_CACHE.get(key)
    if hit is None:
        ant_index = {a: i for i, a in enumerate(antnums)}
        hit = np.array([(ant_index[b0], ant_index[b1]) for b0, b1 in baselines],
                       dtype=np.int64).reshape(len(baselines), 2)
        hit.setflags(write=False)
        PLAN_CACHE.put(key, hit)
    return hit


def _pair_plan(antnums: list, baselines, beam_idx, nbl: int):
    """The beam-pair plan and every baseline's flip flag (frozen)."""
    pair_plan = plan_beam_pairs(antnums, baselines, beam_idx)
    flipped = np.zeros(nbl, dtype=bool)
    for sel, fl in zip(pair_plan.bls_idxs, pair_plan.flipped):
        flipped[sel] = fl
    flipped.setflags(write=False)
    return pair_plan, flipped


def _culled_rotation(ra, dec, times, telescope_loc, coord_method, include_ab):
    """The rotation with its static horizon cull applied, and the keep mask
    (None when no source was dropped); its arrays frozen."""
    rot = SourceRotation(ra, dec, times, telescope_loc, coord_method=coord_method,
                         include_aberration=include_ab)
    # Static horizon cull: sources below the horizon at every simulated
    # time are exact zeros; dropping them shrinks every device shape.
    src_keep = rot.cull_never_visible()
    if src_keep is not None:
        logger.info(
            "horizon culling: %d / %d sources never rise during the "
            "simulated times", src_keep.size - rot.nsrc, src_keep.size,
        )
        src_keep.setflags(write=False)
    for arr in (rot.eq_vectors, rot.matrices, rot.aberration):
        if arr is not None:
            arr.setflags(write=False)
    return rot, src_keep


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


def fetch(vis: torch.Tensor, polarized: bool) -> VisibilityFuture:
    """The future of the (nt, nfreq, nfeeds, nfeeds, nbl) device output: on
    a CUDA device, its copy into a pinned host buffer is enqueued on the
    current stream behind an event, and nothing waits; a CPU output is
    assembled at once."""
    assemble = functools.partial(assemble_output, polarized=polarized)
    if vis.device.type == "cpu":
        return VisibilityFuture.from_result(assemble(vis.numpy()))
    host = torch.empty(vis.shape, dtype=vis.dtype, pin_memory=True)
    host.copy_(vis, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(vis.device))
    return VisibilityFuture(vis, host, event, assemble)


def assemble_output(vis: np.ndarray, polarized: bool) -> np.ndarray:
    """(nt, nfreq, nfeeds, nfeeds, nbl) device output -> the reference
    layout, a C-contiguous array of its own (ref cpu_simulate.py:849-854):
    polarized (nfreq, nt, nfeeds, nfeeds, nbl), else (nfreq, nt, nbl). It
    never shares ``vis``'s memory, which may be a pinned buffer that goes
    back to the allocator."""
    vis = np.transpose(vis, (1, 0, 2, 3, 4))
    return np.array(vis if polarized else vis[:, :, 0, 0, :], order="C")
