"""Public API: ``simulate_vis``.

The signature is that of ``fftvis_tpu.simulate_vis`` (itself the reference
fftvis/matvis wrapper's) plus ``device``, the torch device the simulation
runs on. The port simulates unpolarized and polarized visibilities of a
coplanar or non-coplanar array with one beam shared by all antennas,
per-antenna beams (a beam list and ``beam_idx``) or an eigenbeam basis
(``beam_coefs``), analytic or tabulated; a gridded array takes the exact
type-1 transform, or the ES type-1 past its reach or under
``FFTVIS_TYPE1=es``. What it leaves out (``mesh``) raises
``NotImplementedError`` naming its ROADMAP item, and nothing falls back to
another path.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from .beams.gridded import GriddedBeam
from .beams.interface import BeamInterface, prepare_beam_unpolarized
from .core.simulate import default_accuracy_dict
from .core.utils import get_desired_chunks, validate_beam_idx
from .cuda.engine import CUDASimulationEngine, VisibilityFuture


def prepare_beam_list(beam, freqs, polarized, beam_coefs, use_feed, nant, beam_idx):
    """Normalize user beams into a validated ``BeamInterface`` list and
    ``beam_idx`` (the JAX wrapper's ``prepare_beam_list``): wrap each beam,
    put tabulated beams on the simulation frequencies, convert to power
    beams for unpolarized runs. Eigenbeams with ``beam_coefs`` must be
    polarized and take no ``beam_idx``."""
    beams = beam if isinstance(beam, list) else [beam]
    beam_idx = validate_beam_idx(beam_idx, beam_coefs, len(beams), nant)
    beam_list = []
    for b in beams:
        bi = BeamInterface(b)
        # Tabulated beams go onto the simulation frequencies first, so an
        # unpolarized run takes the power of the interpolated E-field, as
        # the JAX wrapper does.
        if isinstance(bi.beam, GriddedBeam) and bi.beam.Nfreqs > 1:
            bi = BeamInterface(bi.beam.interp_freq(freqs), beam_type=bi.beam_type)
        if not polarized and beam_coefs is not None:
            raise ValueError(
                "Basis decomposition is not compatible with unpolarized "
                "simulations. Set polarized=True to use beam_coefs."
            )
        beam_list.append(bi if polarized else prepare_beam_unpolarized(bi, use_feed=use_feed))
    return beam_list, beam_idx


def simulate_vis(
    ants: dict,
    fluxes: np.ndarray,
    ra: np.ndarray,
    dec: np.ndarray,
    freqs: np.ndarray,
    times,
    beam,
    telescope_loc,
    beam_idx: np.ndarray = None,
    baselines: list[tuple] = None,
    precision: int = 2,
    polarized: bool = False,
    eps: float = None,
    upsample_factor: Literal[1.25, 2] | None = None,
    beam_spline_opts: dict = None,
    use_feed: str = "x",
    flat_array_tol: float = 1e-6,
    interpolation_function: str = "az_za_map_coordinates",
    nprocesses: int | None = 1,
    nthreads: int | None = None,
    coord_method: str = "CoordinateRotationERFA",
    coord_method_params: dict | None = None,
    force_use_type3: bool = False,
    force_use_ray: bool = False,
    trace_mem: bool = False,
    backend: str = "tpu",
    max_memory: int | float = np.inf,
    min_chunks: int = 1,
    source_buffer: float = 1.0,
    beam_coefs: np.ndarray = None,
    mesh=None,
    async_fetch: bool = False,
    device="cuda",
) -> np.ndarray | VisibilityFuture:
    """Simulate interferometric visibilities on a torch device.

    Parameters mirror ``fftvis_tpu.simulate_vis``: ``ants`` {antenna: ENU
    position in m}, ``fluxes`` (nsrc, nfreq) Stokes I or (nsrc, nfreq, 4)
    IQUV (``polarized=True`` only), ``ra``/``dec`` in radians, ``freqs`` in
    Hz, ``times`` as Julian dates, one ``beam``: analytic, a
    :class:`~fftvis_tpu_torch.beams.GriddedBeam` (e.g. from
    ``read_beamfits``) or a UVBeam-like object. ``polarized`` adds the 2x2
    feed matrix. ``beam_spline_opts`` (``{"order": 1 or 3}``, or
    ``kx``/``ky``), ``interpolation_function`` and ``use_feed`` select how
    a tabulated beam is interpolated and which feed an unpolarized run
    uses. ``precision`` 1 runs float32/complex64, 2 float64/complex128
    (default eps 6e-8 / 1e-13, floored at 5e-7 in float32). ``device``
    names the torch device (default ``"cuda"``).

    ``max_memory`` (bytes, capped at the device's free memory), ``min_chunks``
    and ``source_buffer`` choose the number of source chunks by the JAX
    package's memory model (``get_desired_chunks``); the engine's source
    block is then at most ``ceil(nsrc / nchunks)``. They change the blocking,
    not the result. ``async_fetch=True`` returns a :class:`VisibilityFuture`
    as soon as the device work and the copy of its output are enqueued;
    ``result()`` (or ``np.asarray``) waits and assembles. On a CPU device
    the future is already resolved.

    Accepted for signature parity and without effect on this path:
    ``nprocesses``, ``nthreads``, ``force_use_ray``, ``trace_mem``,
    ``backend``.

    ``beam`` may be a list with ``beam_idx`` mapping antennas to it
    (inferred when the list has one beam or one per antenna), or K
    eigenbeams (``compute_beam_basis``) with ``beam_coefs`` (nant, K,
    nfreq), polarized only. Baselines are routed by beam pair. Auto-rank, as
    in the JAX package: a polarized per-antenna list of 8 beam pairs or more
    at an eps of 1e-9 or more is replaced by K eigenbeams and per-antenna
    coefficients when an SVD of its tables reaches a residual of ``eps / 8``
    with at most half the channels (logged at INFO;
    ``FFTVIS_AUTO_RANK=0`` turns it off). A non-coplanar array runs the
    low-rank-z type-3 or the direct path, as the cost model picks; 8 times
    or more of 4096 sources or more run horizon-banded (``FFTVIS_BAND=0``
    turns it off). A gridded array runs the exact type-1 transform while its
    mode grid holds at most 512^2 cells, else (and under
    ``FFTVIS_TYPE1=es``) the ES type-1; ``FFTVIS_TYPE1=exact`` forces the
    exact one. A float32 run (``precision=1``) forms its transform
    coordinates in float64 on every path. Raises ``NotImplementedError`` for
    ``mesh`` (ROADMAP item 10).

    Plans, device tables, device inputs and prepared beams are kept across
    calls under content keys (``cuda/engine.py``), so a sweep over one
    configuration plans and uploads once.

    Returns
    -------
    np.ndarray
        (nfreqs, ntimes, nbls) complex, or (nfreqs, ntimes, 2, 2, nbls)
        when polarized. With ``async_fetch=True``, a ``VisibilityFuture``
        resolving to that array.
    """
    if mesh is not None:
        raise NotImplementedError("mesh (multi-device runs) is ROADMAP item 10")
    if eps is None:
        eps = default_accuracy_dict[precision]
    freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
    beam_list, beam_idx = prepare_beam_list(beam, freqs, polarized, beam_coefs, use_feed,
                                            len(ants), beam_idx)
    nfeed = 2 if polarized else 1
    nchunks, _ = get_desired_chunks(
        min(max_memory, available_memory(device)), min_chunks,
        [b.beam for b in beam_list], nfeed, nfeed, len(ants), len(fluxes), precision,
        source_buffer=source_buffer,
    )

    engine = CUDASimulationEngine(device=device)
    return engine.simulate(
        async_fetch=async_fetch,
        nchunks=nchunks,
        ants={k: np.asarray(v) for k, v in ants.items()},
        freqs=freqs,
        fluxes=np.asarray(fluxes),
        beam_list=beam_list,
        ra=np.asarray(ra, dtype=float),
        dec=np.asarray(dec, dtype=float),
        times=times,
        telescope_loc=telescope_loc,
        baselines=baselines,
        beam_idx=beam_idx,
        precision=precision,
        polarized=polarized,
        eps=eps,
        upsample_factor=upsample_factor,
        beam_spline_opts=beam_spline_opts,
        flat_array_tol=flat_array_tol,
        interpolation_function=interpolation_function,
        coord_method=coord_method,
        coord_method_params=coord_method_params,
        force_use_type3=force_use_type3,
        beam_coefs=beam_coefs,
    )


def available_memory(device) -> float:
    """The memory budget in bytes: the free memory of a CUDA device, else
    the host's available memory (``/proc/meminfo``), else 8 GiB."""
    device = torch.device(device)
    if device.type == "cuda":
        return float(torch.cuda.mem_get_info(device)[0])
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable"):
                    return float(line.split()[1]) * 1024.0
    except OSError:  # pragma: no cover
        pass
    return 8 * 1024**3  # pragma: no cover
