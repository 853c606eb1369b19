"""Polarized coherency and the tabulated/polarized slice end to end: the
port on the CPU vs ``fftvis_tpu`` and vs the exact float64 oracle.

Same inputs on every side: hex_array(3) with its redundant baselines plus
reversed (j, i) pairs, the nside=8 HEALPix sky, fluxes from one NumPy seed
(Stokes I, or IQUV), 2 frequencies x 2 times. Beams: the committed
``tests/data/structured_dipole_100MHz.beamfits`` (read by each package's
``read_beamfits``; it loads as a float64-valued table) and the analytic
``ShortDipoleBeam``. Tolerances, relative to max|V|:

- port vs fftvis_tpu: 1e-9 at precision=2 (one algorithm in float64), 1e-4
  at precision=1;
- port vs the direct oracle (DirectSimulationEngine): 1e-5 at precision=2,
  1e-4 at precision=1, the repo's gates.

With a single shared beam no baseline is flip-conjugated; the reversed
pairs exercise the feed transpose of the polarized output.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fftvis_tpu import TelescopeLocation as JaxLocation
from fftvis_tpu import simulate_vis as jax_simulate_vis
from fftvis_tpu.beams import ShortDipoleBeam as JaxShortDipole
from fftvis_tpu.beams import io as jax_io
from fftvis_tpu.beams.interface import BeamInterface as JaxBeamInterface
from fftvis_tpu.beams.interface import prepare_beam_unpolarized as jax_unpolarized
from fftvis_tpu.core import coherency as jax_coh
from fftvis_tpu.reference.direct_engine import DirectSimulationEngine
from fftvis_tpu.tpu.engine import TPUSimulationEngine
from fftvis_tpu_torch import CUDASimulationEngine, TelescopeLocation, simulate_vis
from fftvis_tpu_torch.beams import BeamInterface, ShortDipoleBeam, prepare_beam_unpolarized
from fftvis_tpu_torch.beams import eval as eval_mod
from fftvis_tpu_torch.beams import read_beamfits
from fftvis_tpu_torch.core import coherency
from fftvis_tpu_torch.core.utils import get_pos_reds
from fftvis_tpu_torch.geometry import hex_array
from fftvis_tpu_torch.nufft import interp as interp_mod
from fftvis_tpu_torch.nufft import spread as spread_mod
from fftvis_tpu_torch.utils import healpix_radec

ASSET = str(Path(__file__).resolve().parent / "data" / "structured_dipole_100MHz.beamfits")
SITE = (np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
VS_REFERENCE = {2: 1e-9, 1: 1e-4}
VS_ORACLE = {2: 1e-5, 1: 1e-4}


def _beams(kind):
    """(port beam, fftvis_tpu beam) of one kind."""
    if kind == "tabulated":
        return read_beamfits(ASSET), jax_io.read_beamfits(ASSET)
    return ShortDipoleBeam(), JaxShortDipole()


def _inputs(iquv=False, **extra):
    ants = hex_array(3)
    reds = [red[0] for red in get_pos_reds(ants, include_autos=True)]
    ra, dec = healpix_radec(8)
    rng = np.random.default_rng(0)
    flux = rng.uniform(0.1, 1.0, (ra.size, 2))
    if iquv:
        flux = np.stack([flux, *(rng.uniform(-0.05, 0.05, (3, ra.size, 2)))], axis=-1)
    return dict(
        ants=ants, ra=ra, dec=dec, fluxes=flux,
        freqs=np.array([1.0e8, 1.1e8]),
        times=2459863.2 + np.linspace(0, 0.01, 2),
        baselines=reds + [(j, i) for (i, j) in reds[1:8]],
        **extra,
    )


def _oracle(jbeam, kw):
    return DirectSimulationEngine().simulate(
        beam_list=[jbeam], telescope_loc=JaxLocation(*SITE),
        **{k: v for k, v in kw.items() if k != "force_use_type3"})


def _check(got, want, oracle, precision, shape):
    scale = np.abs(oracle).max()
    assert got.shape == want.shape == oracle.shape == shape
    assert got.dtype == want.dtype
    assert np.abs(got - want).max() / scale <= VS_REFERENCE[precision]
    assert np.abs(got - oracle).max() / scale <= VS_ORACLE[precision]


def _rows_inputs(n=64, seed=5):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(2, 2, 2, n)) + 1j * rng.normal(size=(2, 2, 2, n))
    flux = rng.uniform(0.1, 1, n)
    sky = rng.uniform(0.1, 1, (n, 1, 4))
    return e, flux, sky


@pytest.mark.parametrize("iquv", [False, True])
def test_polarized_coherency_rows_match_reference(iquv):
    e, flux, sky = _rows_inputs()
    if iquv:
        assert coherency.classify_sky(sky, True) and jax_coh.classify_sky(sky, True)
        coh = coherency.build_coherency(sky, True)
        assert np.array_equal(coh, jax_coh.build_coherency(sky, True))
        f = coh[:, 0]
    else:
        f = flux
    got = coherency.apparent_coherency_rows(torch.from_numpy(e[0]), torch.from_numpy(e[1]),
                                            torch.from_numpy(f), True, iquv).numpy()
    want = np.asarray(jax_coh.apparent_coherency_rows(jnp.asarray(e[0]), jnp.asarray(e[1]),
                                                      jnp.asarray(f), True, iquv))
    assert got.shape == want.shape == (4, e.shape[-1])
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-15)


def test_iquv_sky_needs_a_polarized_simulation():
    _, _, sky = _rows_inputs()
    with pytest.raises(ValueError, match="polarized_beam=False"):
        coherency.classify_sky(sky, False)


def _beam_lists(kind, polarized):
    """(port, fftvis_tpu) engine beam lists of one kind."""
    beam, jbeam = _beams(kind)
    pb, jb = BeamInterface(beam), JaxBeamInterface(jbeam)
    if not polarized:
        pb, jb = prepare_beam_unpolarized(pb), jax_unpolarized(jb)
    return [pb], [jb]


@pytest.mark.parametrize("precision", [2, 1])
@pytest.mark.parametrize("mode,kind,polarized,order", [
    ("type3", "tabulated", True, 3), ("type3", "tabulated", False, 1),
    ("type3", "tabulated", False, 3), ("type3", "analytic", True, None),
    ("type3", "analytic", False, None),
    ("direct", "tabulated", True, 3), ("direct", "tabulated", False, 1),
])
def test_engine_matches_reference_and_oracle(mode, kind, polarized, order, precision):
    """The engines with the transform forced: type-3 (every kernel of the
    port's path) or direct."""
    opts = None if order is None else {"order": order}
    kw = _inputs(precision=precision, polarized=polarized, beam_spline_opts=opts)
    pbeams, jbeams = _beam_lists(kind, polarized)
    got = CUDASimulationEngine(nufft_mode=mode, device="cpu").simulate(
        beam_list=pbeams, telescope_loc=TelescopeLocation(*SITE), **kw)
    want = TPUSimulationEngine(nufft_mode=mode).simulate(
        beam_list=jbeams, telescope_loc=JaxLocation(*SITE), **kw)
    nbl = len(kw["baselines"])
    _check(got, want, _oracle(jbeams[0], kw), precision,
           (2, 2, 2, 2, nbl) if polarized else (2, 2, nbl))


@pytest.mark.parametrize("precision", [2, 1])
@pytest.mark.parametrize("kind,polarized,order", [("tabulated", True, 3),
                                                  ("tabulated", False, 1),
                                                  ("analytic", True, None)])
def test_simulate_vis_matches_reference_and_oracle(kind, polarized, order, precision):
    """Through ``simulate_vis`` on both sides (the planner picks the direct
    path at this size)."""
    beam, jbeam = _beams(kind)
    opts = None if order is None else {"order": order}
    kw = _inputs(precision=precision, polarized=polarized, beam_spline_opts=opts,
                 force_use_type3=True)
    got = simulate_vis(beam=beam, telescope_loc=TelescopeLocation(*SITE), device="cpu", **kw)
    want = jax_simulate_vis(beam=jbeam, telescope_loc=JaxLocation(*SITE), **kw)
    jb = JaxBeamInterface(jbeam)
    oracle = _oracle(jb if polarized else jax_unpolarized(jb), kw)
    nbl = len(kw["baselines"])
    _check(got, want, oracle, precision, (2, 2, 2, 2, nbl) if polarized else (2, 2, nbl))


@pytest.mark.parametrize("precision", [2, 1])
def test_iquv_sky_matches_reference_and_oracle(precision):
    kw = _inputs(iquv=True, precision=precision, polarized=True,
                 beam_spline_opts={"order": 3})
    pbeams, jbeams = _beam_lists("tabulated", True)
    got = CUDASimulationEngine(nufft_mode="type3", device="cpu").simulate(
        beam_list=pbeams, telescope_loc=TelescopeLocation(*SITE), **kw)
    want = TPUSimulationEngine(nufft_mode="type3").simulate(
        beam_list=jbeams, telescope_loc=JaxLocation(*SITE), **kw)
    _check(got, want, _oracle(jbeams[0], kw), precision,
           (2, 2, 2, 2, len(kw["baselines"])))


@pytest.mark.parametrize("options", [
    dict(interpolation_function="az_za_simple"),
    dict(use_feed="y", beam_spline_opts={"order": 3}),
])
def test_beam_options_match_reference(options):
    beam, jbeam = _beams("tabulated")
    polarized = "use_feed" not in options
    kw = _inputs(precision=2, polarized=polarized, force_use_type3=True, **options)
    got = simulate_vis(beam=beam, telescope_loc=TelescopeLocation(*SITE), device="cpu", **kw)
    want = jax_simulate_vis(beam=jbeam, telescope_loc=JaxLocation(*SITE), **kw)
    assert np.abs(got - want).max() / np.abs(want).max() <= VS_REFERENCE[2]


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [2, 1])
def test_cuda_polarized_tabulated_matches_cpu(cuda_device, precision):
    kw = _inputs(precision=precision, polarized=True, beam_spline_opts={"order": 3})
    pbeams, _ = _beam_lists("tabulated", True)
    loc = TelescopeLocation(*SITE)
    want = CUDASimulationEngine(nufft_mode="type3", device="cpu").simulate(
        beam_list=pbeams, telescope_loc=loc, **kw)
    for mod in (spread_mod, interp_mod, eval_mod):
        mod.launches = 0
    eval_mod.rows_launches = 0
    got = CUDASimulationEngine(nufft_mode="type3", device=cuda_device).simulate(
        beam_list=pbeams, telescope_loc=loc, **kw)
    # The tabulated beam runs as fused source blocks, never the
    # interpolation alone.
    assert min(spread_mod.launches, interp_mod.launches, eval_mod.rows_launches) > 0
    assert eval_mod.launches == 0
    assert np.abs(got - want).max() / np.abs(want).max() <= VS_REFERENCE[precision]
