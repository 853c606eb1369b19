"""Beam interface layer: wrapping, unpolarized preparation, prepared beams.

The port of ``fftvis_tpu/beams/interface.py``: ``BeamInterface`` wraps an
analytic beam, a :class:`~fftvis_tpu_torch.beams.gridded.GriddedBeam` or a
(duck-typed) UVBeam and evaluates it on the host in the UVBeam layout
(``compute_response``, which ``compute_beam_basis`` calls);
``PowerBeam`` / ``prepare_beam_unpolarized`` turn it
into a single-feed power beam (matvis's prepare_beam_unpolarized); and
:func:`prepare_beam` compiles it into a :class:`PreparedBeam` whose
``rows`` and ``evaluate`` run on tensors inside the engine's loop.

A tabulated beam is prepared once on the host -- frequency interpolation,
the za-domain check, complex -> stacked (re, im), the cubic-spline
prefilter in float64, the channels-last relayout (nfreq, ny, nx, chflat) --
and its table is taken into the compute dtype and onto the device once, at
first use. ``PreparedBeam.rows`` then forms one source block's masked
coherency rows from it with :func:`~fftvis_tpu_torch.beams.eval.beam_rows`
(one fused CUDA kernel on the card); ``evaluate`` interpolates it with
:func:`~fftvis_tpu_torch.beams.eval.beam_eval`. A per-antenna list
(:func:`prepare_beams`) of same-grid tabulated beams is stacked by
:func:`stack_prepared` into one device table that one ``beam_eval`` launch
a source block interpolates.

Both are content-cached across calls, as the JAX package caches them
(``_PREPARED_CACHE``, ``_STACK_CACHE``): a prepared beam with its device
table and a stacked device table are kept under a key of everything that
changes them, so a repeated call prepares, stacks and uploads nothing. Host
tables are frozen, so their digests are taken once. The
``FFTVIS_BEAM_UPSAMPLE`` resampling is a later ROADMAP item.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..core.coherency import apparent_coherency_rows
from ..core.hashing import LRUCache, beam_fingerprint, hash_parts
from .analytic import AnalyticBeam
from .eval import (
    TableGrid,
    beam_eval,
    beam_rows,
    evals_response,
    grid_cells,
    table_response,
)
from .gridded import GriddedBeam
from .interp import spline_prefilter_2d

logger = logging.getLogger(__name__)

_FEED_INDEX = {"x": 0, "y": 1}


class BeamInterface:
    """Thin wrapper unifying analytic beams, gridded beams, and (duck-typed)
    pyuvdata UVBeam objects."""

    def __init__(self, beam, beam_type: str | None = None):
        if isinstance(beam, BeamInterface):
            self.beam = beam.beam
        elif isinstance(beam, (AnalyticBeam, GriddedBeam, PowerBeam)):
            self.beam = beam
        elif hasattr(beam, "data_array") and hasattr(beam, "axis1_array"):
            self.beam = GriddedBeam.from_uvbeam(beam)
        else:
            raise TypeError(f"Unsupported beam object: {type(beam)}")
        self.beam_type = beam_type or getattr(self.beam, "beam_type", "efield")

    @property
    def _isuvbeam(self) -> bool:
        """True when the underlying beam is tabulated (UVBeam-like)."""
        return isinstance(self.beam, GriddedBeam)

    def compute_response(self, az_array, za_array, freq_array, spline_opts: dict | None = None,
                         interpolation_function: str = "az_za_map_coordinates",
                         **kwargs) -> np.ndarray:
        """Host-side response evaluation with the UVBeam output layout:
        (Naxes_vec, Nfeeds, Nfreqs, Nsrc) complex for an efield beam, (1, 1,
        Nfreqs, Nsrc) real for a power beam. The beam is prepared in
        float64 on the CPU, as the JAX package pins its evaluation to the
        CPU, and the result comes back as a NumPy array."""
        freq_array = np.atleast_1d(np.asarray(freq_array, dtype=float))
        efield = self.beam_type == "efield"
        prepared = prepare_beam(self, freq_array, polarized=efield, spline_opts=spline_opts,
                                interpolation_function=interpolation_function,
                                dtype=torch.float64, device="cpu")
        az = torch.as_tensor(np.asarray(az_array, dtype=float))
        za = torch.as_tensor(np.asarray(za_array, dtype=float))
        out = np.stack([prepared.evaluate(az, za, float(f), fi).numpy()
                        for fi, f in enumerate(freq_array)])  # (nfreq, ..., nsrc)
        return np.moveaxis(out, 0, 2) if efield else out[None, None]


class PowerBeam:
    """A single-feed power beam derived from any beam (matvis's
    prepare_beam_unpolarized equivalent)."""

    beam_type = "power"

    def __init__(self, base, use_feed: str = "x"):
        if isinstance(base, BeamInterface):
            base = base.beam
        if isinstance(base, PowerBeam):
            # Already a power beam of one feed: keep its selection.
            use_feed = base.use_feed
            base = base.base
        self.use_feed = use_feed
        self.base = base.as_power_beam() if isinstance(base, GriddedBeam) else base

    def power(self, az, za, freq: float):
        if isinstance(self.base, GriddedBeam):
            raise RuntimeError("Gridded power beams evaluate via prepare_beam().")
        return self.base.power(az, za, freq, feed=self.use_feed)


def prepare_beam_unpolarized(beam, use_feed: str = "x") -> BeamInterface:
    """Convert any beam to an unpolarized power beam wrapped in an interface."""
    bi = beam if isinstance(beam, BeamInterface) else BeamInterface(beam)
    return BeamInterface(PowerBeam(bi.beam, use_feed=use_feed), beam_type="power")


class PreparedBeam:
    """A beam ready for the engine's loop.

    ``evaluate(az, za, freq_value, freq_index)`` returns
      - polarized: (2 vec, 2 feed, nsrc) complex Jones response;
      - unpolarized: (nsrc,) real power response,
    in the dtype of ``za``. ``freq_value`` is a host float (analytic beams);
    ``freq_index`` indexes the simulation frequencies (gridded tables are
    interpolated onto them at prepare time). A tabulated beam also carries
    its host table (nfreq, ny, nx, chflat) and its ``grid``; its device
    ``table`` is uploaded at first use, so a beam that only goes into a
    stack (:func:`stack_prepared`) never is.
    """

    def __init__(self, evaluate_fn, polarized: bool, host_table=None,
                 grid: TableGrid | None = None, dtype: torch.dtype = torch.float64,
                 device="cuda"):
        self._fn = evaluate_fn
        self.polarized = polarized
        self.host_table = host_table
        self.grid = grid
        self.dtype = dtype
        self.device = torch.device(device)
        self._table = None

    @property
    def table(self):
        if self.host_table is not None and self._table is None:
            self._table = torch.tensor(self.host_table, dtype=self.dtype, device=self.device)
        return self._table

    @property
    def stack_spec(self):
        """What beams must share to stack: table shape and grid; None for an
        analytic beam."""
        if self.host_table is None:
            return None
        return (self.host_table.shape, self.grid)

    def evaluate(self, az, za, freq_value: float, freq_index: int):
        if self.grid is None:
            return self._fn(az, za, freq_value, freq_index)
        g = self.grid
        yy, xx = grid_cells(az, za, g)
        return table_response(beam_eval(self.table[freq_index], yy, xx, order=g.order,
                                        wrap_x=g.wrap), g)

    def rows(self, az, za, freq_value: float, freq_index: int, flux, mask,
             polarized_sky: bool, complex_dtype: torch.dtype) -> torch.Tensor:
        """One source block's (C, nsrc) apparent-coherency rows times the
        horizon ``mask``, in ``complex_dtype``: the beam response and
        ``apparent_coherency_rows`` for this beam with itself. ``flux`` is
        the sky at this frequency, (nsrc,) real or (nsrc, 2, 2) complex
        (IQUV). A tabulated beam takes the fused
        :func:`~fftvis_tpu_torch.beams.eval.beam_rows`."""
        if self.grid is not None:
            rows = beam_rows(self.table[freq_index], az, za, flux, mask, self.grid,
                             polarized_sky)
            return rows.to(complex_dtype)
        resp = self.evaluate(az, za, freq_value, freq_index)
        rows = apparent_coherency_rows(resp, resp, flux, self.polarized, polarized_sky)
        return rows.to(complex_dtype) * mask[None, :]


class StackedBeams:
    """K same-grid tabulated beams as one device table, (nfreq, ny, nx, K *
    chflat), beam-major inside the channel axis (the JAX stacking order),
    uploaded once. ``channels`` interpolates it at one source block with one
    :func:`~fftvis_tpu_torch.beams.eval.beam_eval` launch; ``evaluate_all``
    gives the responses as the JAX ``BatchedPreparedBeams.evaluate_all``
    does: (K, 2 vec, 2 feed, n) Jones or (K, n) power."""

    def __init__(self, table: torch.Tensor, grid: TableGrid, nbeams: int):
        self.table = table
        self.grid = grid
        self.nbeams = nbeams
        self.polarized = not grid.is_power

    def channels(self, az, za, freq_index: int) -> torch.Tensor:
        g = self.grid
        yy, xx = grid_cells(az, za, g)
        return beam_eval(self.table[freq_index], yy, xx, order=g.order, wrap_x=g.wrap)

    def evaluate_all(self, az, za, freq_value: float, freq_index: int):
        g = self.grid
        return evals_response(self.channels(az, za, freq_index), g.ch_shape, g.is_power,
                              g.feed)


# Prepared beams by content. The limit must exceed the distinct beams of one
# call, or every call evicts the whole list (the 37-beam north star);
# prepare_beams grows it to twice the largest list seen, capped.
PREPARED_CACHE = LRUCache(64)
PREPARED_CACHE_MAX_LIMIT = 1024
# Stacked device tables by content.
STACK_CACHE = LRUCache(8)


def stack_prepared(prepared_list) -> StackedBeams | None:
    """Fuse same-grid tabulated :class:`PreparedBeam` s into one
    :class:`StackedBeams`: one interpolation a source block serves all K.
    None when the list is shorter than 2 or its beams do not share table
    shape, grid, spline order and kind (a mixed analytic and tabulated list,
    for one): the engine then evaluates beam by beam, as the JAX package
    does. The stacked table goes to the first beam's device and dtype, and
    is kept in :data:`STACK_CACHE` under the tables' content."""
    if len(prepared_list) < 2:
        return None
    specs = [pb.stack_spec for pb in prepared_list]
    if any(s is None for s in specs) or any(s != specs[0] for s in specs[1:]):
        return None
    first = prepared_list[0]
    key = hash_parts((specs[0], tuple(pb.host_table for pb in prepared_list),
                      str(first.dtype), str(first.device)))
    hit = STACK_CACHE.get(key)
    if hit is not None:
        return hit
    # Per-beam tables are channels-last (nfreq, ny, nx, chflat); the beam
    # axis goes INTO the channel axis so one gather serves all K. Each
    # table goes to the device as it is, and the stack and the dtype cast
    # run there: on the host they cost more than the upload (PERF.md).
    parts = [torch.tensor(pb.host_table, device=first.device) for pb in prepared_list]
    stacked = torch.stack(parts, dim=3).to(first.dtype)
    nfreq_t, ny_t, nx_t = stacked.shape[:3]
    return STACK_CACHE.put(key, StackedBeams(stacked.reshape(nfreq_t, ny_t, nx_t, -1),
                                             first.grid, len(prepared_list)))


def prepare_beams(beam_list, freqs, polarized, spline_opts=None,
                  interpolation_function="az_za_map_coordinates", use_feed="x",
                  dtype: torch.dtype = torch.float64, device="cuda") -> list:
    """Prepare every beam of a list (the engine's entry point)."""
    want = min(2 * len(beam_list), PREPARED_CACHE_MAX_LIMIT)
    PREPARED_CACHE.limit = max(PREPARED_CACHE.limit, want)
    return [
        prepare_beam(b, freqs, polarized, spline_opts=spline_opts,
                     interpolation_function=interpolation_function, use_feed=use_feed,
                     dtype=dtype, device=device)
        for b in beam_list
    ]


def _spline_order(spline_opts: dict | None, interpolation_function: str) -> int:
    """The interpolation order from ``beam_spline_opts`` and the
    ``interpolation_function`` name, by the JAX package's rules."""
    spline_opts = dict(spline_opts or {})
    # pyuvdata spells the order 'order' for az_za_map_coordinates and
    # 'kx'/'ky' for az_za_simple; honor both.
    if "kx" in spline_opts or "ky" in spline_opts:
        kx = int(spline_opts.get("kx", spline_opts.get("ky", 3)))
        ky = int(spline_opts.get("ky", kx))
        if kx != ky:
            raise ValueError(
                f"anisotropic spline orders are not supported (kx={kx}, ky={ky})"
            )
        spline_opts.setdefault("order", kx)
    unknown = set(spline_opts) - {"order", "kx", "ky"}
    if unknown:
        logger.info("ignoring unsupported beam_spline_opts keys: %s", sorted(unknown))
    order = int(spline_opts.get("order", 1))
    if interpolation_function == "az_za_simple":
        # Both names map onto the same evaluator; 'simple' is the cubic.
        order = int(spline_opts.get("order", 3))
    elif interpolation_function != "az_za_map_coordinates":
        raise ValueError(
            "interpolation_function must be 'az_za_simple' or 'az_za_map_coordinates'"
        )
    if order not in (1, 3):
        raise ValueError(f"spline order must be 1 or 3, got {order}")
    return order


def prepare_beam(
    beam,
    freqs: np.ndarray,
    polarized: bool,
    spline_opts: dict | None = None,
    interpolation_function: str = "az_za_map_coordinates",
    use_feed: str = "x",
    dtype: torch.dtype = torch.float64,
    device="cuda",
) -> PreparedBeam:
    """Compile one beam into a :class:`PreparedBeam` for the simulation
    frequencies ``freqs``; a tabulated beam's table goes to ``device`` in
    ``dtype`` once, at its first use.

    Results are kept in :data:`PREPARED_CACHE` under the beam's content and
    every argument and environment knob that changes them, so a sweep's
    later calls neither interpolate, prefilter nor upload a table again.
    """
    # Wrapped first: a UVBeam-like object becomes a GriddedBeam, keyed by
    # its tables and not by its identity.
    bi = beam if isinstance(beam, BeamInterface) else BeamInterface(beam)
    key = hash_parts((
        beam_fingerprint(bi),
        np.asarray(freqs, dtype=float),
        bool(polarized),
        repr(spline_opts),
        interpolation_function,
        use_feed,
        # Whether a short za grid raises or clamps is decided here.
        os.environ.get("FFTVIS_ALLOW_BEAM_CLAMP", ""),
        os.environ.get("FFTVIS_BEAM_UPSAMPLE", ""),
        str(dtype),
        str(torch.device(device)),
    ))
    hit = PREPARED_CACHE.get(key)
    if hit is not None:
        return hit
    return PREPARED_CACHE.put(key, _prepare_beam_uncached(
        bi, freqs, polarized, spline_opts, interpolation_function, use_feed, dtype, device))


def _prepare_beam_uncached(bi, freqs, polarized, spline_opts, interpolation_function,
                           use_feed, dtype, device) -> PreparedBeam:
    inner = bi.beam
    order = _spline_order(spline_opts, interpolation_function)

    if isinstance(inner, PowerBeam) and not isinstance(inner.base, GriddedBeam):
        if polarized:
            raise ValueError("Power beams cannot be evaluated polarized.")
        return PreparedBeam(lambda az, za, fv, fi: inner.power(az, za, fv),
                            polarized=False, dtype=dtype, device=device)

    if isinstance(inner, AnalyticBeam):
        if polarized:
            return PreparedBeam(lambda az, za, fv, fi: inner.efield(az, za, fv),
                                polarized=True, dtype=dtype, device=device)
        return PreparedBeam(
            lambda az, za, fv, fi: inner.power(az, za, fv, feed=use_feed),
            polarized=False, dtype=dtype, device=device,
        )

    # Gridded beams (including a PowerBeam over a gridded base).
    gb = inner.base if isinstance(inner, PowerBeam) else inner
    if not isinstance(gb, GriddedBeam):
        raise TypeError(f"Cannot prepare beam of type {type(inner)}")
    if polarized and gb.beam_type != "efield":
        raise ValueError("polarized=True requires an efield beam")
    if not polarized and gb.beam_type == "efield":
        gb = gb.as_power_beam()

    gb = gb.interp_freq(np.asarray(freqs, dtype=float))
    # pyuvdata's check_azza_domain, decided once: any above-horizon source
    # can reach za = pi/2, so a grid ending short of it would be evaluated
    # out of its domain. Refuse unless clamping to the edge row is asked
    # for (FFTVIS_ALLOW_BEAM_CLAMP=1).
    za_end = float(gb.axis2_array[-1])
    if za_end < np.pi / 2 - 1e-9:
        if os.environ.get("FFTVIS_ALLOW_BEAM_CLAMP") == "1":
            logger.warning(
                "beam za grid ends at %.4f rad < pi/2: above-horizon "
                "sources beyond it clamp to the edge row "
                "(FFTVIS_ALLOW_BEAM_CLAMP=1)", za_end,
            )
        else:
            raise ValueError(
                f"beam za grid ends at {za_end:.4f} rad < pi/2: "
                "above-horizon sources can fall outside the beam domain "
                "(check_azza_domain). Extend the beam grid to the horizon, "
                "or set FFTVIS_ALLOW_BEAM_CLAMP=1 to clamp to the edge row."
            )
    host = gb.data_array
    is_complex = np.iscomplexobj(host)
    wrap = gb.az_wraps
    if is_complex:
        # Interpolation distributes over re/im: one real table of both.
        host = np.stack([host.real, host.imag])
    ups = int(os.environ.get("FFTVIS_BEAM_UPSAMPLE", "0") or "0")
    if order == 3 and ups >= 2 and host.shape[-1] > 1 and host.shape[-2] > 1:
        raise NotImplementedError(
            "FFTVIS_BEAM_UPSAMPLE (upsample_prefiltered_2d) is not ported "
            "yet: ROADMAP item 6"
        )
    if order == 3:
        host = spline_prefilter_2d(host, periodic_x=wrap)
    az0 = float(gb.axis1_array[0])
    daz = float(gb.axis1_array[1] - gb.axis1_array[0]) if gb.axis1_array.size > 1 else 1.0
    za0 = float(gb.axis2_array[0])
    dza = float(gb.axis2_array[1] - gb.axis2_array[0]) if gb.axis2_array.size > 1 else 1.0
    # Channels-last (nfreq, ny, nx, chflat), chflat = the flattened
    # ([2 reim,] nvec, nfeed) axes: every tap reads one contiguous
    # ch-vector.
    freq_axis = 3 if is_complex else 2
    ch_shape = host.shape[:freq_axis]
    host = np.moveaxis(host, freq_axis, 0)  # (nfreq, *ch_shape, ny, nx)
    nfreq_t, ny_t, nx_t = host.shape[0], host.shape[-2], host.shape[-1]
    host = np.ascontiguousarray(np.moveaxis(host.reshape(nfreq_t, -1, ny_t, nx_t), 1, -1))
    if host.base is not None:  # keep a table of its own, so freezing it is safe
        host = host.copy()
    host.setflags(write=False)  # the stack key's digest is then taken once
    is_power = gb.beam_type == "power"
    # A PowerBeam carries its own feed selection (the engine prepares
    # without use_feed).
    want_feed = inner.use_feed if isinstance(inner, PowerBeam) else use_feed
    labels = gb.feeds
    if labels and want_feed in labels:
        feed_idx = labels.index(want_feed)
    elif labels and is_power:
        raise ValueError(
            f"requested feed {want_feed!r} is not present in this beam "
            f"(feeds: {labels})"
        )
    else:
        feed_idx = _FEED_INDEX[want_feed]

    grid = TableGrid(za0=za0, dza=dza, az0=az0, daz=daz, order=order, wrap=wrap,
                     ch_shape=ch_shape, is_complex=is_complex, is_power=is_power,
                     feed=feed_idx)
    return PreparedBeam(None, polarized=not is_power, host_table=host, grid=grid,
                        dtype=dtype, device=device)
