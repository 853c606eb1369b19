from .analytic import (
    AiryBeam,
    AnalyticBeam,
    GaussianBeam,
    ShortDipoleBeam,
    UniformBeam,
    beam_from_reference,
)
from .eval import beam_eval, beam_eval_plain, pair_rows, pair_rows_plain
from .gridded import GriddedBeam
from .interface import (
    BeamInterface,
    PowerBeam,
    PreparedBeam,
    StackedBeams,
    prepare_beam,
    prepare_beam_unpolarized,
    prepare_beams,
    stack_prepared,
)
from .interp import map_coordinates_2d, spline_prefilter_2d
from .io import read_beamfits
from .synth import perturbed_variants, structured_dipole_beam

__all__ = [
    "AiryBeam",
    "AnalyticBeam",
    "BeamInterface",
    "GaussianBeam",
    "GriddedBeam",
    "PowerBeam",
    "PreparedBeam",
    "ShortDipoleBeam",
    "StackedBeams",
    "UniformBeam",
    "beam_eval",
    "beam_eval_plain",
    "beam_from_reference",
    "map_coordinates_2d",
    "pair_rows",
    "pair_rows_plain",
    "perturbed_variants",
    "prepare_beam",
    "prepare_beam_unpolarized",
    "prepare_beams",
    "read_beamfits",
    "spline_prefilter_2d",
    "stack_prepared",
    "structured_dipole_beam",
]
