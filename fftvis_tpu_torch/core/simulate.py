"""Simulation engine abstraction and the precision policy.

The port of ``fftvis_tpu/core/simulate.py``. The card has float64, so
``precision=2`` runs natively in float64/complex128 at the reference's
eps 1e-13; there is no degraded mode.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch

# Default NUFFT accuracy per precision level {1: fp32, 2: fp64}
# (ref core/simulate.py:16-19).
default_accuracy_dict = {1: 6e-8, 2: 1e-13}


class SimulationEngine(ABC):
    """Abstract visibility simulation engine."""

    @abstractmethod
    def simulate(self, *args, **kwargs):
        """Simulate visibilities: (nfreqs, ntimes, nbls) complex for
        unpolarized simulations (ref cpu_simulate.py:849-854)."""


def resolve_precision(precision: int) -> tuple[torch.dtype, torch.dtype]:
    """Map the API precision level to (real, complex) torch dtypes."""
    if precision == 1:
        return torch.float32, torch.complex64
    if precision == 2:
        return torch.float64, torch.complex128
    raise ValueError("precision must be 1 or 2")
