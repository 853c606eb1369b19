"""Public API: ``simulate_vis``.

The signature is that of ``fftvis_tpu.simulate_vis`` (itself the reference
fftvis/matvis wrapper's) plus ``device``, the torch device the simulation
runs on. The slice simulates unpolarized visibilities of a coplanar array
with one analytic beam; what it leaves out raises ``NotImplementedError``
naming its ROADMAP item, and nothing falls back to another path.
"""

from __future__ import annotations

from typing import Literal

import numpy as np

from .beams.interface import BeamInterface, prepare_beam_unpolarized
from .core.simulate import default_accuracy_dict
from .cuda.engine import CUDASimulationEngine


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
) -> np.ndarray:
    """Simulate interferometric visibilities on a torch device.

    Parameters mirror ``fftvis_tpu.simulate_vis``: ``ants`` {antenna: ENU
    position in m}, ``fluxes`` (nsrc, nfreq) Stokes I, ``ra``/``dec`` in
    radians, ``freqs`` in Hz, ``times`` as Julian dates, one analytic
    ``beam``. ``precision`` 1 runs float32/complex64, 2 float64/complex128
    (default eps 6e-8 / 1e-13, floored at 5e-7 in float32). ``device``
    names the torch device (default ``"cuda"``).

    Accepted for signature parity and without effect on this path:
    ``beam_spline_opts``, ``interpolation_function``, ``nprocesses``,
    ``nthreads``, ``force_use_ray``, ``trace_mem``, ``backend``,
    ``max_memory``, ``min_chunks``, ``source_buffer``.

    Raises ``NotImplementedError`` for ``polarized=True``, several beams or
    a ``beam_idx``, ``beam_coefs``, tabulated beams, ``mesh``,
    ``async_fetch``, non-coplanar arrays, and gridded arrays unless type-3
    is forced.

    Returns
    -------
    np.ndarray
        (nfreqs, ntimes, nbls) complex.
    """
    if mesh is not None or async_fetch:
        raise NotImplementedError(
            "mesh and async_fetch are ROADMAP items 10 and 5"
        )
    if eps is None:
        eps = default_accuracy_dict[precision]
    beam_list = [
        prepare_beam_unpolarized(BeamInterface(b), use_feed=use_feed)
        for b in (beam if isinstance(beam, list) else [beam])
    ]

    engine = CUDASimulationEngine(device=device)
    return engine.simulate(
        ants={k: np.asarray(v) for k, v in ants.items()},
        freqs=np.atleast_1d(np.asarray(freqs, dtype=float)),
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
        flat_array_tol=flat_array_tol,
        coord_method=coord_method,
        coord_method_params=coord_method_params,
        force_use_type3=force_use_type3,
        beam_coefs=beam_coefs,
    )
