"""Eigenbeam bases: the port's ``compute_beam_basis``, ``compute_response`` and
``simulate_vis(beam_coefs=...)`` on the CPU against ``fftvis_tpu`` and the
exact float64 oracle.

The cases of the JAX package's ``tests/test_beam_basis.py``, held against it
on the same seeded NumPy inputs: Gaussian beams tabulated on (46, 91)
grids, or analytic, a handful of antennas and 60 sources. An SVD is free to
return its singular vectors with another phase (or, for near-degenerate
singular values, another basis), so the port is held to what does not
depend on that choice: the rank, the singular values (the coefficients'
column norms), the reconstruction ``coefs @ eigenbeams`` (1e-12 of the
JAX one) and the visibilities. Tolerances, relative to max|V|: 1e-9 (p=2)
and 1e-4 (p=1) against fftvis_tpu, 1e-5 against the direct oracle's basis
contraction (``fftvis_tpu/reference/direct_engine.py`` ``_basis_vis``), on
the direct path, type-3 and a gridded array's exact type-1 path.
"""

import numpy as np
import pytest
import torch

from fftvis_tpu import TelescopeLocation as JaxLocation
from fftvis_tpu import compute_beam_basis as jax_compute_beam_basis
from fftvis_tpu.beams import GaussianBeam as JaxGaussian
from fftvis_tpu.beams import GriddedBeam as JaxGridded
from fftvis_tpu.beams.interface import BeamInterface as JaxBeamInterface
from fftvis_tpu.beams.interface import prepare_beam_unpolarized as jax_unpolarized
from fftvis_tpu.reference.direct_engine import DirectSimulationEngine
from fftvis_tpu.tpu.engine import TPUSimulationEngine
from fftvis_tpu.wrapper import prepare_beam_list as jax_prepare_beam_list
from fftvis_tpu_torch import (
    CUDASimulationEngine,
    TelescopeLocation,
    compute_beam_basis,
    simulate_vis,
)
from fftvis_tpu_torch.beams import GaussianBeam, GriddedBeam
from fftvis_tpu_torch.beams.interface import BeamInterface, prepare_beam_unpolarized
from fftvis_tpu_torch.geometry import hex_array
from fftvis_tpu_torch.wrapper import prepare_beam_list

SITE = (np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JD0 = 2459863.2
FREQ = 1.0e8
VS_REFERENCE = {2: 1e-9, 1: 1e-4}
VS_ORACLE = 1e-5
# Paths: the engine's nufft_mode on hex_array(2), a lattice, whose auto mode
# takes the exact type-1 path.
MODES = {"direct": "direct", "type3": "type3", "type1": "auto"}


def _gridded(n=3, n_az=91, n_za=46):
    """(port, fftvis_tpu) GaussianBeam(6 + 2i) tabulations on one grid: the
    JAX tables, the port's beams on the same arrays."""
    jbeams = [JaxGridded.from_function(JaxGaussian(diameter=6.0 + 2.0 * i), n_az=n_az,
                                       n_za=n_za, freqs=(FREQ,)) for i in range(n)]
    return [GriddedBeam(b.data_array, b.axis1_array, b.axis2_array, b.freq_array, b.beam_type,
                        feeds=b.feeds) for b in jbeams], jbeams


def _analytic(n=3):
    return ([GaussianBeam(diameter=10.0 + 0.5 * i) for i in range(n)],
            [JaxGaussian(diameter=10.0 + 0.5 * i) for i in range(n)])


def _both(kind, n=3):
    return _gridded(n) if kind == "gridded" else _analytic(n)


def _table(eigenbeams):
    return np.stack([np.asarray(e.data_array).ravel() for e in eigenbeams])


# ---------------------------------------------------- compute_response

@pytest.mark.parametrize("kind", ["gridded efield", "gridded power", "analytic efield",
                                  "analytic power"])
def test_compute_response_matches_reference(kind):
    beams, jbeams = _both(kind.split()[0], 1)
    bi, jbi = BeamInterface(beams[0]), JaxBeamInterface(jbeams[0])
    if kind.endswith("power"):
        bi, jbi = prepare_beam_unpolarized(bi), jax_unpolarized(jbi)
    rng = np.random.default_rng(1)
    az, za = rng.uniform(0, 2 * np.pi, 200), rng.uniform(0, np.pi / 2, 200)
    freqs = np.array([FREQ, 1.02 * FREQ])
    got = bi.compute_response(az, za, freqs)
    want = jbi.compute_response(az, za, freqs)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert got.shape == ((1, 1) if kind.endswith("power") else (2, 2)) + (2, 200)
    assert bi._isuvbeam == jbi._isuvbeam == (kind == "gridded efield")  # not a PowerBeam
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# ---------------------------------------------------- compute_beam_basis

@pytest.mark.parametrize("polarized", [True, False], ids=["efield", "power"])
@pytest.mark.parametrize("kind", ["gridded", "analytic"])
def test_basis_shapes_rank_and_reconstruction(kind, polarized):
    """Rank, singular values and the reconstruction of every beam equal the
    JAX package's; the reconstruction also gives the tables back."""
    beams, jbeams = _both(kind)
    grid = {} if kind == "gridded" else {"n_axis1": 46, "n_axis2": 23}
    eig, coefs = compute_beam_basis(beams, FREQ, polarized, threshold=1e-12, **grid)
    jeig, jcoefs = jax_compute_beam_basis(jbeams, FREQ, polarized, threshold=1e-12, **grid)
    assert coefs.shape == jcoefs.shape == (3, len(eig)) and len(eig) == len(jeig) <= 3
    for e, je in zip(eig, jeig):
        assert isinstance(e, GriddedBeam) and e.beam_type == je.beam_type
        assert e.data_array.shape == je.data_array.shape
        assert np.array_equal(e.axis1_array, je.axis1_array)
        assert np.array_equal(e.axis2_array, je.axis2_array)
        assert e.az_wraps == je.az_wraps
    s, js = np.linalg.norm(coefs, axis=0), np.linalg.norm(jcoefs, axis=0)
    np.testing.assert_allclose(s, js, rtol=1e-12, atol=0)
    rec, jrec = coefs @ _table(eig), jcoefs @ _table(jeig)
    assert np.abs(rec - jrec).max() <= 1e-12 * np.abs(jrec).max()
    if kind == "gridded" and polarized:
        want = np.stack([np.asarray(b.data_array).ravel() for b in beams])
        np.testing.assert_allclose(rec, want, rtol=0, atol=1e-10)


def test_basis_on_the_eigen_rows_grid():
    """The JAX bench's eigenbeam row grid, linspace(0, 2 pi, 181) by
    linspace(0, pi, 91): azimuth endpoint included (the seam column is
    dropped: 180 columns, wrapped), zenith angles past the horizon."""
    beams, jbeams = _analytic(4)
    eig, coefs = compute_beam_basis(beams, FREQ, True, threshold=1e-8, n_axis1=181, n_axis2=91)
    jeig, jcoefs = jax_compute_beam_basis(jbeams, FREQ, True, threshold=1e-8, n_axis1=181,
                                          n_axis2=91)
    assert len(eig) == len(jeig)
    assert eig[0].data_array.shape == jeig[0].data_array.shape == (2, 2, 1, 91, 180)
    assert eig[0].az_wraps and jeig[0].az_wraps
    np.testing.assert_array_equal(eig[0].axis1_array, jeig[0].axis1_array)
    rec, jrec = coefs @ _table(eig), jcoefs @ _table(jeig)
    assert np.abs(rec - jrec).max() <= 1e-12 * np.abs(jrec).max()


def test_eigen_rows_basis_at_full_size():
    """The bench's eigen row itself: 37 GaussianBeam(13 + 0.05 i) at
    threshold 1e-8. In float64 both packages keep K = 6 (the seventh
    singular value is below 1e-8 of the first); the JAX package evaluating
    in float32 keeps two more, rounding noise at ~1e-8."""
    n = 37
    eig, coefs = compute_beam_basis([GaussianBeam(diameter=13.0 + 0.05 * i) for i in range(n)],
                                    FREQ, True, threshold=1e-8, n_axis1=181, n_axis2=91)
    jeig, jcoefs = jax_compute_beam_basis(
        [JaxGaussian(diameter=13.0 + 0.05 * i) for i in range(n)], FREQ, True, threshold=1e-8,
        n_axis1=181, n_axis2=91)
    assert len(eig) == len(jeig) == 6
    np.testing.assert_allclose(np.linalg.norm(coefs, axis=0), np.linalg.norm(jcoefs, axis=0),
                               rtol=1e-9, atol=0)
    rec, jrec = coefs @ _table(eig), jcoefs @ _table(jeig)
    assert np.abs(rec - jrec).max() <= 1e-12 * np.abs(jrec).max()


def test_threshold_monotonicity():
    beams, jbeams = _gridded(4)
    ks = [len(compute_beam_basis(beams, FREQ, True, threshold=t)[0]) for t in (1e-12, 1e-2)]
    jks = [len(jax_compute_beam_basis(jbeams, FREQ, True, threshold=t)[0])
           for t in (1e-12, 1e-2)]
    assert ks == jks and ks[1] <= ks[0]


@pytest.mark.parametrize("case", ["empty", "threshold", "freq", "axes", "power beam"])
def test_basis_validation_matches_reference(case):
    beams, jbeams = _gridded(1)
    pbeam, jpbeam = prepare_beam_unpolarized(beams[0]), jax_unpolarized(jbeams[0])
    args, jargs, kw = {
        "empty": ([], [], {}),
        "threshold": (beams, jbeams, {"threshold": 0.0}),
        "freq": (beams, jbeams, {"freq": np.array([1e8, 2e8])}),
        "axes": (beams, jbeams, {"axis1_array": np.arange(3.0)}),
        "power beam": ([pbeam], [jpbeam], {}),
    }[case]
    freq = kw.pop("freq", FREQ)
    with pytest.raises(ValueError) as want:
        jax_compute_beam_basis(jargs, freq, True, **kw)
    with pytest.raises(ValueError) as got:
        compute_beam_basis(args, freq, True, **kw)
    assert str(got.value) == str(want.value)


def test_identical_beams_rank_one():
    beams, jbeams = _gridded(1)
    eig, coefs = compute_beam_basis(beams * 3, FREQ, True, threshold=1e-8)
    jeig, _ = jax_compute_beam_basis(jbeams * 3, FREQ, True, threshold=1e-8)
    assert len(eig) == len(jeig) == 1 and coefs.shape == (3, 1)


# ---------------------------------------------------- simulate_vis

def _sim_inputs(nbeam=4):
    ants = hex_array(2)
    keys = list(ants)
    rng = np.random.default_rng(0)
    nsrc = 60
    return dict(
        ants=ants, fluxes=rng.uniform(0.2, 1.0, (nsrc, 1)),
        ra=rng.uniform(0, 2 * np.pi, nsrc),
        dec=np.clip(SITE[0] + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2),
        freqs=np.array([FREQ]), times=JD0 + np.linspace(0, 0.01, 2), polarized=True,
        baselines=[(keys[i], keys[j]) for i in range(7) for j in range(i, 7)],
    )


def _coefs_for(coefs, nant):
    """(nant, K, 1) coefficients: antenna a takes input beam a % nbeam."""
    return coefs[np.arange(nant) % coefs.shape[0]][:, :, None]


@pytest.mark.parametrize("precision", [2, 1])
@pytest.mark.parametrize("path", list(MODES))
def test_basis_visibilities_match_reference_and_oracle(path, precision):
    """The JAX package's eigenbeams and coefficients through both engines,
    and the direct oracle's basis contraction."""
    kw = _sim_inputs()
    _, jbeams = _gridded(4)
    jeig, jcoefs = jax_compute_beam_basis(jbeams, FREQ, True, threshold=1e-12)
    eig = [GriddedBeam(e.data_array, e.axis1_array, e.axis2_array, e.freq_array, e.beam_type)
           for e in jeig]
    beam_coefs = _coefs_for(jcoefs, len(kw["ants"]))
    pbl, _ = prepare_beam_list(eig, kw["freqs"], True, beam_coefs, "x", 7, None)
    jbl, _ = jax_prepare_beam_list(jeig, kw["freqs"], True, beam_coefs, "x", 7, None)
    kw.update(precision=precision, beam_coefs=beam_coefs)
    got = CUDASimulationEngine(nufft_mode=MODES[path], device="cpu").simulate(
        beam_list=pbl, telescope_loc=TelescopeLocation(*SITE), **kw)
    want = TPUSimulationEngine(nufft_mode=MODES[path]).simulate(
        beam_list=jbl, telescope_loc=JaxLocation(*SITE), **kw)
    oracle = DirectSimulationEngine().simulate(beam_list=jbl, telescope_loc=JaxLocation(*SITE),
                                               **kw)
    scale = np.abs(oracle).max()
    assert got.shape == want.shape == oracle.shape == (1, 2, 2, 2, 28)
    assert got.dtype == want.dtype
    assert np.abs(got - want).max() / scale <= VS_REFERENCE[precision]
    if precision == 2:
        assert np.abs(got - oracle).max() / scale <= VS_ORACLE


def test_port_basis_gives_the_reference_visibilities():
    """The port's own basis of the same beams (its own SVD, whatever phases
    it chose) through simulate_vis: the JAX package's visibilities."""
    kw = _sim_inputs()
    beams, jbeams = _gridded(4)
    eig, coefs = compute_beam_basis(beams, FREQ, True, threshold=1e-12)
    jeig, jcoefs = jax_compute_beam_basis(jbeams, FREQ, True, threshold=1e-12)
    got = simulate_vis(beam=eig, beam_coefs=_coefs_for(coefs, 7),
                       telescope_loc=TelescopeLocation(*SITE), device="cpu", **kw)
    from fftvis_tpu import simulate_vis as jax_simulate_vis

    want = jax_simulate_vis(beam=jeig, beam_coefs=_coefs_for(jcoefs, 7),
                            telescope_loc=JaxLocation(*SITE), **kw)
    assert np.abs(got - want).max() / np.abs(want).max() <= VS_REFERENCE[2]


@pytest.mark.parametrize("case", ["unpolarized", "beam_idx"])
def test_basis_refusals_match_reference(case):
    """An unpolarized call with beam_coefs, and beam_idx beside beam_coefs,
    raise the JAX wrapper's errors."""
    beams, jbeams = _gridded(2)
    coefs = np.ones((7, 2, 1))
    polarized = case != "unpolarized"
    beam_idx = np.arange(7) % 2 if case == "beam_idx" else None
    with pytest.raises(ValueError) as want:
        jax_prepare_beam_list(jbeams, np.array([FREQ]), polarized, coefs, "x", 7, beam_idx)
    kw = _sim_inputs()
    kw.update(polarized=polarized)
    with pytest.raises(ValueError) as got:
        simulate_vis(beam=beams, beam_coefs=coefs, beam_idx=beam_idx,
                     telescope_loc=TelescopeLocation(*SITE), device="cpu", **kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_cuda_basis_matches_the_cpu():
    """The basis path on the card (the stacked beam_eval and pair_rows
    kernels, the contraction on the device) against the CPU's plain
    versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fftvis_tpu_torch.beams import eval as eval_mod

    kw = _sim_inputs()
    beams, _ = _gridded(4)
    eig, coefs = compute_beam_basis(beams, FREQ, True, threshold=1e-12)
    kw.update(beam=eig, beam_coefs=_coefs_for(coefs, 7), telescope_loc=TelescopeLocation(*SITE))
    want = simulate_vis(device="cpu", **kw)
    before = (eval_mod.launches, eval_mod.pair_launches)
    got = simulate_vis(device="cuda", **kw)
    assert eval_mod.launches > before[0] and eval_mod.pair_launches > before[1]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
