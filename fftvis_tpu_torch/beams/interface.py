"""Beam interface layer for the port's slice: analytic, unpolarized beams.

The port of the part of ``fftvis_tpu/beams/interface.py`` the slice runs:
``BeamInterface`` wraps a beam, ``PowerBeam`` / ``prepare_beam_unpolarized``
turn it into a single-feed power beam (matvis's prepare_beam_unpolarized),
and :func:`prepare_beam` compiles it into a :class:`PreparedBeam` whose
``evaluate`` runs on tensors inside the engine's loop. Tabulated (UVBeam-like)
beams and polarized evaluation raise ``NotImplementedError``: ROADMAP item 6.
"""

from __future__ import annotations

from .analytic import AnalyticBeam


def _not_ported(beam) -> NotImplementedError:
    return NotImplementedError(
        f"beam type {type(beam).__name__} is not ported yet: tabulated and "
        "polarized beams are ROADMAP item 6"
    )


class BeamInterface:
    """Thin wrapper over an analytic beam or a power beam."""

    def __init__(self, beam, beam_type: str | None = None):
        if isinstance(beam, BeamInterface):
            self.beam = beam.beam
        elif isinstance(beam, (AnalyticBeam, PowerBeam)):
            self.beam = beam
        else:
            raise _not_ported(beam)
        self.beam_type = beam_type or getattr(self.beam, "beam_type", "efield")


class PowerBeam:
    """A single-feed power beam derived from an analytic beam (matvis's
    prepare_beam_unpolarized equivalent)."""

    beam_type = "power"

    def __init__(self, base, use_feed: str = "x"):
        if isinstance(base, BeamInterface):
            base = base.beam
        if isinstance(base, PowerBeam):
            # Already a power beam of one feed: keep its selection.
            use_feed = base.use_feed
            base = base.base
        if not isinstance(base, AnalyticBeam):
            raise _not_ported(base)
        self.use_feed = use_feed
        self.base = base

    def power(self, az, za, freq: float):
        return self.base.power(az, za, freq, feed=self.use_feed)


def prepare_beam_unpolarized(beam, use_feed: str = "x") -> BeamInterface:
    """Convert a beam to an unpolarized power beam wrapped in an interface."""
    bi = beam if isinstance(beam, BeamInterface) else BeamInterface(beam)
    return BeamInterface(PowerBeam(bi.beam, use_feed=use_feed), beam_type="power")


class PreparedBeam:
    """A beam ready for the engine's loop.

    ``evaluate(az, za, freq_value, freq_index)`` returns the (nsrc,) real
    power response in the dtype of ``za``. ``freq_value`` is a host float;
    ``freq_index`` indexes the simulation frequencies (tabulated beams will
    need it; analytic beams do not).
    """

    polarized = False

    def __init__(self, power_beam: PowerBeam):
        self._beam = power_beam

    def evaluate(self, az, za, freq_value: float, freq_index: int):
        del freq_index
        return self._beam.power(az, za, freq_value)


def prepare_beam(beam, polarized: bool = False, use_feed: str = "x") -> PreparedBeam:
    """Compile one analytic beam into a :class:`PreparedBeam`."""
    if polarized:
        raise NotImplementedError("polarized beams are ROADMAP item 6")
    inner = (beam if isinstance(beam, BeamInterface) else BeamInterface(beam)).beam
    if not isinstance(inner, PowerBeam):
        inner = PowerBeam(inner, use_feed=use_feed)
    return PreparedBeam(inner)
