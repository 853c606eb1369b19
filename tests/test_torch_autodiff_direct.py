"""The port's differentiable direct front-end
(``fftvis_tpu_torch.autodiff.build_differentiable_direct_sim``).

Every case of ``tests/test_autodiff_direct.py`` on the CPU:

1. values against the JAX package's float64 direct oracle
   (``fftvis_tpu/reference/direct_engine.py``) at 1e-12 of max|V|, across
   polarization, per-antenna beams and flipped baselines;
2. gradients in source positions, antenna positions, fluxes, beam tables
   and gains against central finite differences, and against ``jax.grad``
   of the JAX front-end's loss on the same inputs (``params_from_reference``;
   1e-9 of the largest entry at precision 2, 1e-4 at precision 1) -- with a
   tabulated beam the position gradient runs through the beam-table
   interpolation's coordinate adjoint;
3. repeated calls and ``torch.optim`` fits compose.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fftvis_tpu
from fftvis_tpu.autodiff import build_differentiable_direct_sim as jax_direct_sim
from fftvis_tpu.beams import GaussianBeam as JGaussianBeam
from fftvis_tpu.beams.gridded import GriddedBeam as JGriddedBeam
from fftvis_tpu.beams.interface import BeamInterface, prepare_beam_unpolarized
from fftvis_tpu.reference.direct_engine import DirectSimulationEngine
from fftvis_tpu_torch.autodiff import build_differentiable_direct_sim, params_from_reference
from fftvis_tpu_torch.beams import GaussianBeam
from fftvis_tpu_torch.beams.gridded import GriddedBeam
from fftvis_tpu_torch.coords import TelescopeLocation

LOC = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JLOC = fftvis_tpu.TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
GATE = {1: 1e-4, 2: 1e-9}


def _setup(nant=4, nsrc=12, nfreq=2, ntime=2, seed=0):
    rng = np.random.default_rng(seed)
    ants = {i: np.array([*rng.uniform(-40, 40, 2), 0.0]) for i in range(nant)}
    ra = rng.uniform(0, 2 * np.pi, nsrc)
    dec = np.arcsin(rng.uniform(-1, 1, nsrc))
    freqs = np.linspace(1.0e8, 1.2e8, nfreq)
    times = 2459863.2 + np.linspace(0, 0.01, ntime)
    return rng, ants, ra, dec, freqs, times


def _gridded_beams(n, freqs, n_az=73, n_za=37):
    """(port, JAX) lists of n tabulated beams from one function each."""
    args = dict(n_az=n_az, n_za=n_za, freqs=tuple(float(f) for f in freqs))
    return ([GriddedBeam.from_function(GaussianBeam(diameter=12.0 + 0.5 * i), **args)
             for i in range(n)],
            [JGriddedBeam.from_function(JGaussianBeam(diameter=12.0 + 0.5 * i), **args)
             for i in range(n)])


def _port(ants, fluxes, ra, dec, freqs, times, beam, **kw):
    return build_differentiable_direct_sim(ants, fluxes, ra, dec, freqs, times, beam, LOC,
                                           device="cpu", **kw)


def _jax(ants, fluxes, ra, dec, freqs, times, beam, **kw):
    return jax_direct_sim(ants, fluxes, ra, dec, freqs, times, beam, JLOC, **kw)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _loss_fn(sim_fn, data):
    data = torch.as_tensor(np.asarray(data))
    return lambda p: (sim_fn(p) - data).abs().pow(2).sum()


def _against_reference(sim, params, jsim, jparams, precision=2, scale=1.01):
    """Values and loss gradients against the JAX front-end on the same
    float64 parameters."""
    jp = {k: jnp.asarray(np.asarray(v, dtype=np.float64)) for k, v in jparams.items()}
    p = params_from_reference({k: np.asarray(v) for k, v in jp.items()}, params)
    want = np.asarray(jsim(jp))
    assert _rel(sim(p).detach().numpy(), want) <= GATE[precision]
    data = want * scale
    jg = jax.grad(lambda q: jnp.sum(jnp.abs(jsim(q) - data) ** 2))(jp)
    grads = torch.autograd.grad(_loss_fn(sim, data)(p), list(p.values()))
    for key, g in zip(p, grads):
        assert _rel(g.numpy(), jg[key]) <= GATE[precision], key


# ---------------------------------------------------------------------------
# 1. value parity vs the fp64 direct oracle
# ---------------------------------------------------------------------------


def test_value_parity_unpolarized():
    rng, ants, ra, dec, freqs, times = _setup()
    fluxes = rng.uniform(0.1, 1.0, (ra.size, freqs.size))
    sim_fn, params = _port(ants, fluxes, ra, dec, freqs, times, GaussianBeam(diameter=12.0))
    got = sim_fn(params).detach().numpy()
    want = DirectSimulationEngine().simulate(
        ants=ants, freqs=freqs, fluxes=fluxes,
        beam_list=[prepare_beam_unpolarized(BeamInterface(JGaussianBeam(diameter=12.0)))],
        ra=ra, dec=dec, times=times, telescope_loc=JLOC, polarized=False,
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("iquv", [False, True])
def test_value_parity_polarized_perantenna(iquv):
    """Per-antenna tabulated beams: pair routing and flips."""
    rng, ants, ra, dec, freqs, times = _setup(nant=4, nsrc=10)
    if iquv:
        fluxes = rng.uniform(0.1, 1.0, (ra.size, freqs.size, 4))
        fluxes[..., 1:] *= 0.1
    else:
        fluxes = rng.uniform(0.1, 1.0, (ra.size, freqs.size))
    beams, jbeams = _gridded_beams(2, freqs)
    beam_idx = np.array([0, 1, 1, 0])
    sim_fn, params = _port(ants, fluxes, ra, dec, freqs, times, beams, beam_idx=beam_idx,
                           polarized=True)
    got = sim_fn(params).detach().numpy()
    want = DirectSimulationEngine().simulate(
        ants=ants, freqs=freqs, fluxes=fluxes,
        beam_list=[BeamInterface(b) for b in jbeams], beam_idx=beam_idx,
        ra=ra, dec=dec, times=times, telescope_loc=JLOC, polarized=True,
    )
    assert got.shape == want.shape
    assert got.shape[:4] == (freqs.size, times.size, 2, 2)
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


def test_value_parity_explicit_baselines_and_simple_coords():
    rng, ants, ra, dec, freqs, times = _setup(nant=3, nsrc=8, nfreq=1)
    fluxes = rng.uniform(0.1, 1.0, (ra.size, 1))
    baselines = [(0, 1), (2, 0), (1, 1)]
    sim_fn, params = _port(ants, fluxes, ra, dec, freqs, times, GaussianBeam(diameter=12.0),
                           baselines=baselines, coord_method="simple")
    got = sim_fn(params).detach().numpy()
    want = DirectSimulationEngine().simulate(
        ants=ants, freqs=freqs, fluxes=fluxes,
        beam_list=[prepare_beam_unpolarized(BeamInterface(JGaussianBeam(diameter=12.0)))],
        ra=ra, dec=dec, times=times, telescope_loc=JLOC,
        baselines=baselines, polarized=False, coord_method="simple",
    )
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


# ---------------------------------------------------------------------------
# 2. gradients vs central finite differences and the JAX front-end
# ---------------------------------------------------------------------------


def _fd_check(loss, params, key, picks, rel=2e-5, h=None):
    """Central finite differences on a few entries of params[key]."""
    (g,) = torch.autograd.grad(loss(params), [params[key]])
    base = params[key].detach()
    h = h if h is not None else 1e-5 * max(1.0, float(base.abs().max()))
    with torch.no_grad():
        for idx in picks:
            pert = base.clone()
            pert[idx] += h
            lp = float(loss({**params, key: pert}))
            pert[idx] -= 2 * h
            lm = float(loss({**params, key: pert}))
            fd = (lp - lm) / (2 * h)
            got = float(g[idx])
            assert np.isfinite(got)
            assert abs(got - fd) <= rel * max(abs(fd), abs(got), 1e-3), (key, idx, got, fd)


def test_grad_source_positions():
    rng, ants, ra, dec, freqs, times = _setup(nant=3, nsrc=6, nfreq=1, ntime=1)
    dec = np.clip(dec, -1.2, -0.2)  # well above the horizon
    fluxes = rng.uniform(0.5, 1.0, (ra.size, 1))
    args = (ants, fluxes, ra, dec, freqs, times)
    sim_fn, params = _port(*args, GaussianBeam(diameter=12.0), differentiate_positions=True)
    with torch.no_grad():
        data = sim_fn(params) * 1.01
    loss = _loss_fn(sim_fn, data)
    _fd_check(loss, params, "ra", [(0,), (3,)], h=1e-7)
    _fd_check(loss, params, "dec", [(1,), (4,)], h=1e-7)
    jsim, jparams = _jax(*args, JGaussianBeam(diameter=12.0), differentiate_positions=True)
    _against_reference(sim_fn, params, jsim, jparams)


def test_grad_antenna_positions():
    rng, ants, ra, dec, freqs, times = _setup(nant=4, nsrc=6, nfreq=1, ntime=1)
    dec = np.clip(dec, -1.2, -0.2)
    fluxes = rng.uniform(0.5, 1.0, (ra.size, 1))
    args = (ants, fluxes, ra, dec, freqs, times)
    sim_fn, params = _port(*args, GaussianBeam(diameter=12.0), differentiate_antpos=True)
    with torch.no_grad():
        data = sim_fn(params) * (1 + 0.02j)
    _fd_check(_loss_fn(sim_fn, data), params, "antpos", [(0, 0), (1, 1), (2, 2)], h=1e-6)
    jsim, jparams = _jax(*args, JGaussianBeam(diameter=12.0), differentiate_antpos=True)
    _against_reference(sim_fn, params, jsim, jparams)


def test_grad_fluxes_and_gains():
    rng, ants, ra, dec, freqs, times = _setup(nant=3, nsrc=6, nfreq=2, ntime=1)
    dec = np.clip(dec, -1.2, -0.2)
    fluxes = rng.uniform(0.5, 1.0, (ra.size, freqs.size))
    args = (ants, fluxes, ra, dec, freqs, times)
    sim_fn, params = _port(*args, GaussianBeam(diameter=12.0), differentiate_gains=True)
    with torch.no_grad():
        data = sim_fn(params) * 0.98
    loss = _loss_fn(sim_fn, data)
    _fd_check(loss, params, "fluxes", [(0, 0), (3, 1)])
    _fd_check(loss, params, "gains", [(0, 1, 0), (1, 2, 1)], h=1e-6)
    jsim, jparams = _jax(*args, JGaussianBeam(diameter=12.0), differentiate_gains=True)
    _against_reference(sim_fn, params, jsim, jparams, scale=0.98)


def test_grad_beam_table_polarized():
    rng, ants, ra, dec, freqs, times = _setup(nant=3, nsrc=6, nfreq=1, ntime=1)
    dec = np.clip(dec, -1.2, -0.2)
    fluxes = rng.uniform(0.5, 1.0, (ra.size, 1))
    beams, jbeams = _gridded_beams(2, freqs)
    args = (ants, fluxes, ra, dec, freqs, times)
    kw = dict(beam_idx=np.array([0, 1, 0]), polarized=True, differentiate_beam=True)
    sim_fn, params = _port(*args, beams, **kw)
    with torch.no_grad():
        data = sim_fn(params) * 1.02
    loss = _loss_fn(sim_fn, data)
    (g,) = torch.autograd.grad(loss(params), [params["beam_table"]])
    assert torch.isfinite(g).all() and g.abs().max() > 0
    idx = np.unravel_index(int(g.abs().argmax()), g.shape)
    _fd_check(loss, params, "beam_table", [idx], rel=1e-3, h=1e-6)
    jsim, jparams = _jax(*args, jbeams, **kw)
    _against_reference(sim_fn, params, jsim, jparams, scale=1.02)


@pytest.mark.parametrize("order", [1, 3])
def test_grad_positions_through_tabulated_beams(order):
    """Positions, antenna positions, the stacked table and gains at once,
    polarized with an IQUV sky and flipped pairs: the position gradient
    runs through the beam-table interpolation's coordinate adjoint."""
    rng, ants, ra, dec, freqs, times = _setup(nant=4, nsrc=8, nfreq=1, ntime=2, seed=3)
    dec = np.clip(dec, -1.2, -0.2)
    fluxes = rng.uniform(0.5, 1.0, (ra.size, 1, 4))
    fluxes[..., 1:] *= 0.1
    beams, jbeams = _gridded_beams(2, freqs, n_az=36, n_za=19)
    args = (ants, fluxes, ra, dec, freqs, times)
    kw = dict(beam_idx=np.array([1, 0, 1, 0]), polarized=True, differentiate_beam=True,
              differentiate_positions=True, differentiate_antpos=True,
              differentiate_gains=True, beam_spline_opts={"order": order})
    sim_fn, params = _port(*args, beams, **kw)
    jsim, jparams = _jax(*args, jbeams, **kw)
    _against_reference(sim_fn, params, jsim, jparams)


def test_precision_1_matches_reference():
    rng, ants, ra, dec, freqs, times = _setup(nant=4, nsrc=10, nfreq=1, ntime=2, seed=4)
    dec = np.clip(dec, -1.2, -0.2)
    fluxes = rng.uniform(0.5, 1.0, (ra.size, 1))
    args = (ants, fluxes, ra, dec, freqs, times)
    kw = dict(precision=1, differentiate_positions=True, differentiate_gains=True)
    sim_fn, params = _port(*args, GaussianBeam(diameter=12.0), **kw)
    jsim, jparams = _jax(*args, JGaussianBeam(diameter=12.0), **kw)
    # A 20% residual: in float32 the position gradient of a 1% residual is
    # a difference of terms 100x its size.
    _against_reference(sim_fn, params, jsim, jparams, precision=1, scale=1.2)


# ---------------------------------------------------------------------------
# 3. composition and validation
# ---------------------------------------------------------------------------


def test_repeated_value_and_grad_compose():
    rng, ants, ra, dec, freqs, times = _setup(nant=3, nsrc=5, nfreq=1, ntime=2)
    fluxes = rng.uniform(0.5, 1.0, (ra.size, 1))
    sim_fn, params = _port(ants, fluxes, ra, dec, freqs, times, GaussianBeam(diameter=12.0),
                           differentiate_positions=True, differentiate_antpos=True)
    with torch.no_grad():
        data = sim_fn(params) * 1.01
    loss = _loss_fn(sim_fn, data)
    keys = ("fluxes", "ra", "dec", "antpos")
    v1 = loss(params)
    g1 = torch.autograd.grad(v1, [params[k] for k in keys])
    v2 = loss(params)
    g2 = torch.autograd.grad(v2, [params[k] for k in keys])
    assert float(v1.detach()) == float(v2.detach())
    for a, b in zip(g1, g2):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


def test_gain_fit_recovers_injected_gain():
    """An injected per-antenna phase gain is recovered by torch.optim.Adam."""
    rng, ants, ra, dec, freqs, times = _setup(nant=3, nsrc=8, nfreq=1, ntime=1)
    dec = np.clip(dec, -1.2, -0.2)
    fluxes = rng.uniform(0.5, 1.0, (ra.size, 1))
    sim_fn, params = _port(ants, fluxes, ra, dec, freqs, times, GaussianBeam(diameter=12.0),
                           differentiate_gains=True)
    true_g = params["gains"].detach().clone()
    true_g[:, 1, 0] = torch.tensor([np.cos(0.3), np.sin(0.3)])  # antenna 1: phase 0.3
    fl = params["fluxes"].detach()
    with torch.no_grad():
        data = sim_fn({"fluxes": fl, "gains": true_g})
    x = params["gains"].detach().clone().requires_grad_()
    opt = torch.optim.Adam([x], lr=5e-2)
    for _ in range(300):
        opt.zero_grad()
        v = (sim_fn({"fluxes": fl, "gains": x}) - data).abs().pow(2).sum()
        v.backward()
        opt.step()
    assert float(v.detach()) < 1e-6 * float(data.abs().pow(2).sum())


def test_differentiate_beam_requires_stacked_tables():
    rng, ants, ra, dec, freqs, times = _setup(nant=3, nsrc=4, nfreq=1, ntime=1)
    fluxes = rng.uniform(0.5, 1.0, (ra.size, 1))
    with pytest.raises(ValueError, match="stacked-table"):
        _port(ants, fluxes, ra, dec, freqs, times, GaussianBeam(diameter=12.0),
              polarized=True, differentiate_beam=True)


def test_bad_sky_shape_raises():
    rng, ants, ra, dec, freqs, times = _setup(nant=3, nsrc=4, nfreq=1, ntime=1)
    fluxes = rng.uniform(0.5, 1.0, (ra.size, 1, 4))
    with pytest.raises(ValueError, match="2D"):
        _port(ants, fluxes, ra, dec, freqs, times, GaussianBeam(diameter=12.0),
              polarized=False)
