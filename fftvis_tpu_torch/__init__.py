"""fftvis-tpu-torch: the PyTorch/CUDA port of fftvis_tpu.

A second package beside the JAX one (which stays the reference): the same
``simulate_vis`` on a torch device, with the JAX package's Pallas kernels
rewritten by hand in CUDA for Hopper (``csrc/``, built with nvcc at first
use). It imports torch and NumPy, never JAX and never ``fftvis_tpu``.
"""

from . import beams, coords, geometry, nufft
from .coords import TelescopeLocation
from .core.beam_basis import compute_beam_basis
from .core.simulate import SimulationEngine, default_accuracy_dict
from .cuda.engine import CUDASimulationEngine, VisibilityFuture, cache_stats, clear_caches
from .wrapper import simulate_vis

__all__ = [
    "CUDASimulationEngine",
    "SimulationEngine",
    "TelescopeLocation",
    "VisibilityFuture",
    "beams",
    "cache_stats",
    "clear_caches",
    "compute_beam_basis",
    "coords",
    "default_accuracy_dict",
    "geometry",
    "nufft",
    "simulate_vis",
]
