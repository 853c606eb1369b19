from .analytic import AiryBeam, AnalyticBeam, GaussianBeam, UniformBeam, beam_from_reference
from .interface import BeamInterface, PowerBeam, PreparedBeam, prepare_beam, prepare_beam_unpolarized

__all__ = [
    "AiryBeam",
    "AnalyticBeam",
    "BeamInterface",
    "GaussianBeam",
    "PowerBeam",
    "PreparedBeam",
    "UniformBeam",
    "beam_from_reference",
    "prepare_beam",
    "prepare_beam_unpolarized",
]
