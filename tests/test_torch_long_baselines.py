"""The float64 coordinate chain of the port's float32 runs on long baselines.

Four antennas at (0, 0), (1, 0), (0, 1) and (L, 0) x 14.6 m, L = 200 and
400 (2.9 and 5.8 km), GaussianBeam(14), nside 4, 100 MHz, 2 times. Each
precision=1 path the planner can take there is held to 1e-4 of max|V|
against the float64 oracle ``fftvis_tpu/reference/direct_engine.py``:

- exact type-1: the array as it is, in ``auto`` mode (a lattice);
- direct: the fourth antenna moved off the lattice by (0.4142, 0.7321)
  cells, in ``auto`` mode;
- type-3: the off-lattice array under ``nufft_mode="type3"``;
- low-rank-z type-3: the off-lattice array with up to +-2 m of z (seed 3)
  under ``nufft_mode="type3"``.

The path each run took is asserted from the planner's log. A float32 chain
misses the gate there: the JAX package's engine on the CPU, on the same
inputs, reaches (L = 200 / 400) exact 1.7e-4 / 3.2e-4, direct 1.6e-4 /
2.9e-4, type-3 1.4e-4 / 2.9e-4 and low-rank-z 1.5e-4 / 6.9e-4 of max|V|. So
these cases hold the port to the oracle, not to the JAX package. At
precision=2 every path stays within 1e-5.
"""

import logging

import numpy as np
import pytest

from fftvis_tpu import TelescopeLocation as JaxLocation
from fftvis_tpu.beams import GaussianBeam as JaxGaussian
from fftvis_tpu.beams.interface import BeamInterface as JaxBeamInterface
from fftvis_tpu.beams.interface import prepare_beam_unpolarized as jax_unpolarized
from fftvis_tpu.reference.direct_engine import DirectSimulationEngine
from fftvis_tpu_torch import CUDASimulationEngine, TelescopeLocation, clear_caches
from fftvis_tpu_torch.beams import GaussianBeam
from fftvis_tpu_torch.utils import healpix_radec
from fftvis_tpu_torch.wrapper import prepare_beam_list

SITE = (np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
SEP = 14.6
GATE = {1: 1e-4, 2: 1e-5}
# (nufft_mode, off the lattice, z scatter in m, the planner's log line).
PATHS = {
    "exact type-1": ("auto", False, 0.0, "Gridded path: exact separable DFT"),
    "direct": ("auto", True, 0.0, "Using exact direct path"),
    "type-3": ("type3", True, 0.0, "Using type-3 NUFFT path (nf="),
    "low-rank-z": ("type3", True, 2.0, "Using type-3 NUFFT path (3D lowrank-z"),
}


def _inputs(L: int, off: bool, z: float, precision: int) -> dict:
    pts = [(0, 0), (1, 0), (0, 1), (L + (0.4142 if off else 0.0), 0.7321 if off else 0.0)]
    rng = np.random.default_rng(3)
    ants = {i: np.array([p[0] * SEP, p[1] * SEP, rng.uniform(-z, z) if z else 0.0])
            for i, p in enumerate(pts)}
    keys = list(ants)
    bls = [(keys[i], keys[j]) for i in range(4) for j in range(i, 4)]
    ra, dec = healpix_radec(4)
    flux = np.random.default_rng(0).uniform(0.1, 1.0, (ra.size, 1))
    return dict(ants=ants, ra=ra, dec=dec, fluxes=flux, freqs=np.array([1.0e8]),
                times=2459863.2 + np.linspace(0, 0.01, 2), baselines=bls, precision=precision)


def _error(path: str, L: int, precision: int, caplog) -> float:
    mode, off, z, line = PATHS[path]
    kw = _inputs(L, off, z, precision)
    beams, beam_idx = prepare_beam_list(GaussianBeam(diameter=14.0), kw["freqs"], False, None,
                                        "x", len(kw["ants"]), None)
    clear_caches()
    with caplog.at_level(logging.INFO, logger="fftvis_tpu_torch.cuda.planning"):
        got = CUDASimulationEngine(nufft_mode=mode, device="cpu").simulate(
            beam_list=beams, beam_idx=beam_idx, telescope_loc=TelescopeLocation(*SITE), **kw)
    assert line in caplog.text
    oracle = DirectSimulationEngine().simulate(
        beam_list=[jax_unpolarized(JaxBeamInterface(JaxGaussian(diameter=14.0)))],
        telescope_loc=JaxLocation(*SITE), **kw)
    assert got.shape == oracle.shape
    assert got.dtype == (np.complex64 if precision == 1 else np.complex128)
    return float(np.abs(got - oracle).max() / np.abs(oracle).max())


@pytest.mark.parametrize("L", [200, 400])
@pytest.mark.parametrize("path", list(PATHS))
def test_precision1_paths_meet_the_gate(path, L, caplog):
    assert _error(path, L, 1, caplog) <= GATE[1]


@pytest.mark.parametrize("path", list(PATHS))
def test_precision2_paths_stay_at_1e5(path, caplog):
    assert _error(path, 400, 2, caplog) <= GATE[2]
