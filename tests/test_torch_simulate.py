"""End to end: the port's simulate_vis (CPU) vs fftvis_tpu's, and vs the
exact float64 oracle.

Same inputs on both sides: hex_array(3), the nside=8 HEALPix sky, fluxes
from one NumPy seed, 2 frequencies x 2 times, GaussianBeam(14),
unpolarized. Tolerances, relative to max|V|:

- port vs fftvis_tpu: 1e-9 at precision=2 (one algorithm in float64; the
  two frameworks round differently), 1e-4 at precision=1;
- port vs the direct oracle (DirectSimulationEngine): the repo's gates,
  1e-5 at precision=2 and 1e-4 at precision=1.
"""

import numpy as np
import pytest

from fftvis_tpu import TelescopeLocation as JaxLocation
from fftvis_tpu import simulate_vis as jax_simulate_vis
from fftvis_tpu.beams import GaussianBeam as JaxGaussian
from fftvis_tpu.beams.interface import BeamInterface as JaxBeamInterface
from fftvis_tpu.beams.interface import prepare_beam_unpolarized as jax_unpolarized
from fftvis_tpu.reference.direct_engine import DirectSimulationEngine
from fftvis_tpu.tpu.engine import TPUSimulationEngine
from fftvis_tpu_torch import CUDASimulationEngine, TelescopeLocation, simulate_vis
from fftvis_tpu_torch.beams import BeamInterface, GaussianBeam, beam_from_reference
from fftvis_tpu_torch.beams import prepare_beam_unpolarized
from fftvis_tpu_torch.geometry import hex_array
from fftvis_tpu_torch.utils import healpix_radec

SITE = (np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
VS_REFERENCE = {2: 1e-9, 1: 1e-4}
VS_ORACLE = {2: 1e-5, 1: 1e-4}


def _sky(nside=8, seed=0):
    ra, dec = healpix_radec(nside)
    flux = np.random.default_rng(seed).uniform(0.1, 1.0, (ra.size, 2))
    return dict(ra=ra, dec=dec, fluxes=flux)


def _common(ants, **extra):
    return dict(
        ants=ants,
        freqs=np.array([1.0e8, 1.1e8]),
        times=2459863.2 + np.linspace(0, 0.01, 2),
        **_sky(),
        **extra,
    )


def _engines(mode, precision, ants, **extra):
    """(port, fftvis_tpu, oracle) outputs of one engine-level call."""
    kw = _common(ants, precision=precision, **extra)
    jbeam = [jax_unpolarized(JaxBeamInterface(JaxGaussian(diameter=14.0)))]
    pbeam = [prepare_beam_unpolarized(BeamInterface(GaussianBeam(diameter=14.0)))]
    got = CUDASimulationEngine(nufft_mode=mode, device="cpu").simulate(
        beam_list=pbeam, telescope_loc=TelescopeLocation(*SITE), **kw)
    ref = TPUSimulationEngine(nufft_mode=mode).simulate(
        beam_list=jbeam, telescope_loc=JaxLocation(*SITE), **kw)
    oracle = DirectSimulationEngine().simulate(
        beam_list=jbeam, telescope_loc=JaxLocation(*SITE), **kw)
    return got, ref, oracle


def _rel(a, b, scale):
    return np.abs(a - b).max() / scale


@pytest.mark.parametrize("precision", [2, 1])
def test_simulate_vis_matches_reference(precision):
    ants = hex_array(3)
    kw = _common(ants, precision=precision, force_use_type3=True)
    got = simulate_vis(beam=GaussianBeam(diameter=14.0),
                       telescope_loc=TelescopeLocation(*SITE), device="cpu", **kw)
    want = jax_simulate_vis(beam=JaxGaussian(diameter=14.0),
                            telescope_loc=JaxLocation(*SITE), **kw)
    assert got.shape == want.shape == (2, 2, 31)
    assert got.dtype == want.dtype
    assert _rel(got, want, np.abs(want).max()) <= VS_REFERENCE[precision]


@pytest.mark.parametrize("precision", [2, 1])
def test_type3_engine_matches_reference_and_oracle(precision):
    got, ref, oracle = _engines("type3", precision, hex_array(3),
                                force_use_type3=True)
    scale = np.abs(oracle).max()
    assert got.shape == oracle.shape == (2, 2, 31)
    assert _rel(got, ref, scale) <= VS_REFERENCE[precision]
    assert _rel(got, oracle, scale) <= VS_ORACLE[precision]


@pytest.mark.parametrize("precision", [2, 1])
def test_direct_mode_matches_reference_and_oracle(precision):
    got, ref, oracle = _engines("direct", precision, hex_array(3))
    scale = np.abs(oracle).max()
    assert _rel(got, ref, scale) <= VS_REFERENCE[precision]
    assert _rel(got, oracle, scale) <= VS_ORACLE[precision]


@pytest.mark.parametrize("precision", [2, 1])
def test_random_array_auto_mode(precision):
    rng = np.random.default_rng(42)
    ants = {i: np.array([*rng.uniform(-60, 60, 2), 0.0]) for i in range(9)}
    got, ref, oracle = _engines("auto", precision, ants)
    scale = np.abs(oracle).max()
    assert _rel(got, ref, scale) <= VS_REFERENCE[precision]
    assert _rel(got, oracle, scale) <= VS_ORACLE[precision]


def test_beam_from_reference():
    beam = beam_from_reference(JaxGaussian(diameter=14.0))
    assert isinstance(beam, GaussianBeam) and beam.diameter == 14.0
    kw = _common(hex_array(3), precision=2, force_use_type3=True)
    loc = TelescopeLocation(*SITE)
    a = simulate_vis(beam=beam, telescope_loc=loc, device="cpu", **kw)
    b = simulate_vis(beam=GaussianBeam(diameter=14.0), telescope_loc=loc,
                     device="cpu", **kw)
    assert np.array_equal(a, b)


def test_gridded_array_without_forcing_raises(monkeypatch):
    """A lattice takes the exact type-1 path (tests/test_torch_type1.py);
    with ES type-1 asked for, which is not ported, it raises."""
    monkeypatch.setenv("FFTVIS_TYPE1", "es")
    kw = _common(hex_array(3), precision=2)
    with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
        simulate_vis(beam=GaussianBeam(diameter=14.0),
                     telescope_loc=TelescopeLocation(*SITE), device="cpu", **kw)
