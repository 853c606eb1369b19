"""The port's differentiable simulation (``fftvis_tpu_torch.autodiff``
``build_differentiable_sim``) against the JAX package's.

Every case of ``tests/test_autodiff.py`` on the port's CPU path, where the
autograd Functions' backward runs the plain adjoints. Where the JAX tests
check values or gradients, the same inputs (one NumPy seed) also go
through ``fftvis_tpu.build_differentiable_sim``, its parameters carried
over by ``params_from_reference``: ``sim_fn`` values and
``torch.autograd.grad`` of the loss sum|sim - data|^2 against ``jax.grad``
of it, gated at 1e-9 of the largest entry at precision 2 and 1e-4 at
precision 1. The comparisons cover forced type-3 (the spread and interp
Functions), exact type-1 on a hex lattice, polarized and IQUV skies,
``differentiate_beam`` on a stacked per-antenna table, gains,
``beam_coefs`` and a horizon-banded run. The JAX mesh case becomes the
check that ``mesh=`` raises, naming ROADMAP item 10; the JAX double-single
refusal has no path here (precision 2 is native float64).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fftvis_tpu
from fftvis_tpu.beams import GaussianBeam as JGaussianBeam
from fftvis_tpu.beams.gridded import GriddedBeam as JGriddedBeam
from fftvis_tpu_torch import build_differentiable_sim, simulate_vis
from fftvis_tpu_torch.autodiff import params_from_reference
from fftvis_tpu_torch.beams import AiryBeam, GaussianBeam
from fftvis_tpu_torch.beams.gridded import GriddedBeam
from fftvis_tpu_torch.coords import TelescopeLocation
from fftvis_tpu_torch.core.utils import get_pos_reds
from fftvis_tpu_torch.geometry import hex_array
from fftvis_tpu_torch.nufft import interp as interp_mod
from fftvis_tpu_torch.nufft import spread as spread_mod
from fftvis_tpu_torch.nufft import type1 as type1_mod

LOC = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JLOC = fftvis_tpu.TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JD0 = 2459863.2
GATE = {1: 1e-4, 2: 1e-9}


def _case(rng, nsrc=48, ntimes=2, nfreq=2, polarized=False, stokes=False, nant=6,
          **extra):
    ants = {i: np.array([*rng.uniform(-60, 60, 2), 0.0]) for i in range(nant)}
    ra = rng.uniform(0, 2 * np.pi, nsrc)
    dec = np.clip(LOC.lat + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2)
    freqs = np.linspace(1.0e8, 1.1e8, nfreq)
    if stokes:
        flux = np.zeros((nsrc, nfreq, 4))
        flux[..., 0] = rng.uniform(0.5, 1.0, (nsrc, nfreq))
        flux[..., 1] = rng.uniform(-0.2, 0.2, (nsrc, nfreq))
        flux[..., 2] = rng.uniform(-0.2, 0.2, (nsrc, nfreq))
        flux[..., 3] = rng.uniform(-0.1, 0.1, (nsrc, nfreq))
    else:
        flux = rng.uniform(0.1, 1.0, (nsrc, nfreq))
    times = JD0 + np.linspace(0, 0.02, ntimes)
    return dict(ants=ants, fluxes=flux, ra=ra, dec=dec, freqs=freqs, times=times,
                polarized=polarized, precision=2, **extra)


def _port(kw, beam, **extra):
    return build_differentiable_sim(beam=beam, telescope_loc=LOC, device="cpu",
                                    **kw, **extra)


def _jax(kw, beam, **extra):
    kw = {k: v for k, v in kw.items() if k != "nufft_mode"}
    return fftvis_tpu.build_differentiable_sim(beam=beam, telescope_loc=JLOC, **kw, **extra)


def _loss(sim_fn, data):
    return lambda p: (sim_fn(p) - torch.as_tensor(data)).abs().pow(2).sum()


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _against_reference(sim, params, jsim, jparams, precision, scale=0.9):
    """Values and loss gradients of the port against the JAX front-end on
    the same parameters (the JAX ones as float64 NumPy arrays)."""
    jp = {k: np.asarray(v, dtype=np.float64) for k, v in jparams.items()}
    p = params_from_reference(jp, params)
    want = np.asarray(jsim({k: jnp.asarray(v) for k, v in jp.items()}))
    got = sim(p).detach().numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= GATE[precision]
    data = want * scale
    jg = jax.grad(lambda q: jnp.sum(jnp.abs(jsim(q) - data) ** 2))(
        {k: jnp.asarray(v) for k, v in jp.items()})
    grads = torch.autograd.grad(_loss(sim, data)(p), list(p.values()))
    for key, g in zip(p, grads):
        assert _rel(g.numpy(), jg[key]) <= GATE[precision], key
    return p


@pytest.mark.parametrize(
    "polarized,stokes,force3",
    [(False, False, True), (True, False, True), (True, True, True),
     (False, False, False)],
)
def test_sim_fn_matches_simulate_vis(polarized, stokes, force3):
    rng = np.random.default_rng(3)
    kw = _case(rng, polarized=polarized, stokes=stokes, force_use_type3=force3)
    if not force3:
        kw["ants"] = hex_array(3)
    mode = {"nufft_mode": "type3"} if force3 else {}
    want = simulate_vis(beam=GaussianBeam(diameter=10.0), telescope_loc=LOC, device="cpu",
                        **kw) if not force3 else None
    sim_fn, params = _port(kw, GaussianBeam(diameter=10.0), **mode)
    got = sim_fn(params).detach().numpy()
    if force3:
        from fftvis_tpu_torch import CUDASimulationEngine
        from fftvis_tpu_torch.wrapper import prepare_beam_list

        beams, idx = prepare_beam_list(GaussianBeam(diameter=10.0), kw["freqs"], polarized,
                                       None, "x", len(kw["ants"]), None)
        ekw = {k: v for k, v in kw.items() if k != "force_use_type3"}
        want = CUDASimulationEngine(nufft_mode="type3", device="cpu").simulate(
            beam_list=beams, beam_idx=idx, telescope_loc=LOC, **ekw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max(), rtol=0)
    jsim, jparams = _jax(kw, JGaussianBeam(diameter=10.0))
    assert _rel(got, np.asarray(jsim(jparams))) <= GATE[2]


def test_grad_fluxes_matches_finite_difference():
    rng = np.random.default_rng(5)
    kw = _case(rng, nsrc=24, force_use_type3=True)
    sim_fn, params = _port(kw, GaussianBeam(diameter=10.0), nufft_mode="type3")
    data = sim_fn(params).detach() * 0.9
    loss = _loss(sim_fn, data)
    (g,) = torch.autograd.grad(loss(params), [params["fluxes"]])
    assert g.shape == params["fluxes"].shape
    f0 = params["fluxes"].detach()
    with torch.no_grad():
        for idx in [(0, 0), (7, 1), (23, 0)]:
            h = 1e-3
            fp, fm = f0.clone(), f0.clone()
            fp[idx] += h
            fm[idx] -= h
            fd = (float(loss({"fluxes": fp})) - float(loss({"fluxes": fm}))) / (2 * h)
            np.testing.assert_allclose(float(g[idx]), fd, rtol=1e-6, atol=1e-12)
    jsim, jparams = _jax(kw, JGaussianBeam(diameter=10.0))
    _against_reference(sim_fn, params, jsim, jparams, 2)


def test_grad_linearity_exactness():
    """d(vis)/d(flux) contracted with w == vis evaluated at flux = w."""
    rng = np.random.default_rng(6)
    kw = _case(rng, nsrc=16, nfreq=1, ntimes=1, force_use_type3=True)
    sim_fn, params = _port(kw, GaussianBeam(diameter=10.0), nufft_mode="type3")
    w = rng.uniform(0.1, 1.0, params["fluxes"].shape)
    shape = sim_fn(params).shape
    c = torch.tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape))
    lin = (sim_fn(params) * torch.conj(c)).real.sum()
    (g,) = torch.autograd.grad(lin, [params["fluxes"]])
    lhs = float((g * torch.tensor(w)).sum())
    with torch.no_grad():
        rhs = float((sim_fn({"fluxes": torch.tensor(w)}) * torch.conj(c)).real.sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def _gridded_pair(i, freqs, n_az=73, n_za=37, diameter=10.0):
    """(port, JAX) tabulated beams from one function."""
    args = dict(n_az=n_az, n_za=n_za, freqs=tuple(float(f) for f in freqs))
    return (GriddedBeam.from_function(GaussianBeam(diameter=diameter + 0.5 * i), **args),
            JGriddedBeam.from_function(JGaussianBeam(diameter=diameter + 0.5 * i), **args))


def test_grad_beam_table():
    """The per-antenna beam-calibration scenario: two same-grid tabulated
    beams ride the stacked-table input (type-3 forced: beam_eval, pair_rows,
    spread and interp backward)."""
    rng = np.random.default_rng(7)
    beams = [_gridded_pair(i, (1.0e8, 1.1e8)) for i in range(2)]
    kw = _case(rng, nsrc=20, force_use_type3=True)
    kw["beam_idx"] = np.arange(len(kw["ants"])) % 2
    sim_fn, params = _port(kw, [b[0] for b in beams], differentiate_beam=True,
                           nufft_mode="type3")
    assert "beam_table" in params
    data = sim_fn(params).detach() * 1.05
    loss = _loss(sim_fn, data)
    (gt,) = torch.autograd.grad(loss(params), [params["beam_table"]])
    assert gt.shape == params["beam_table"].shape
    assert torch.isfinite(gt).all() and gt.abs().max() > 0

    # Finite differences at the largest-|grad| well-conditioned entry (the
    # unpolarized sqrt(B_i B_j) is steep where the power beam is tiny).
    t0 = params["beam_table"].detach()
    cond = t0.abs() > 1e-2 * t0.abs().max()
    idx = np.unravel_index(int(torch.argmax(torch.where(cond, gt, 0).abs())), gt.shape)
    h = 1e-4 * max(1.0, abs(float(t0[idx])))
    with torch.no_grad():
        tp, tm = t0.clone(), t0.clone()
        tp[idx] += h
        tm[idx] -= h
        fd = (float(loss({**params, "beam_table": tp}))
              - float(loss({**params, "beam_table": tm}))) / (2 * h)
    np.testing.assert_allclose(float(gt[idx]), fd, rtol=5e-4)
    jsim, jparams = _jax(kw, [b[1] for b in beams], differentiate_beam=True)
    _against_reference(sim_fn, params, jsim, jparams, 2, scale=1.05)


def test_differentiate_beam_requires_table():
    rng = np.random.default_rng(8)
    kw = _case(rng, force_use_type3=True)
    with pytest.raises(ValueError, match="tabulated"):
        _port(kw, AiryBeam(diameter=10.0), differentiate_beam=True)


def test_ds_switch_takes_no_other_path(monkeypatch):
    """The JAX front-end refuses its double-single path (FFTVIS_DS=1 at
    precision 1); the port has none, so the switch changes nothing."""
    monkeypatch.setenv("FFTVIS_DS", "1")
    rng = np.random.default_rng(9)
    kw = dict(_case(rng, force_use_type3=True), precision=1)
    sim_fn, params = _port(kw, GaussianBeam(diameter=10.0), nufft_mode="type3")
    monkeypatch.delenv("FFTVIS_DS")
    want, _ = _port(kw, GaussianBeam(diameter=10.0), nufft_mode="type3")
    with torch.no_grad():
        assert torch.equal(sim_fn(params), want(params))


def test_optimizer_recovers_fluxes():
    """End-to-end calibration: torch.optim.Adam recovers perturbed fluxes."""
    rng = np.random.default_rng(11)
    kw = _case(rng, nsrc=12, nfreq=1, ntimes=1, nant=5, force_use_type3=True)
    sim_fn, params = _port(kw, GaussianBeam(diameter=10.0))
    true_flux = params["fluxes"].detach().clone()
    with torch.no_grad():
        data = sim_fn({"fluxes": true_flux})
    x = (true_flux * (1.0 + 0.3 * torch.tensor(rng.standard_normal(true_flux.shape))))
    x.requires_grad_()
    opt = torch.optim.Adam([x], lr=3e-2)
    l0 = None
    for _ in range(300):
        opt.zero_grad()
        val = (sim_fn({"fluxes": x}) - data).abs().pow(2).sum()
        val.backward()
        opt.step()
        l0 = float(val.detach()) if l0 is None else l0
    assert float(val.detach()) < 1e-4 * l0


def test_mesh_raises_naming_its_item():
    rng = np.random.default_rng(12)
    kw = _case(rng, nsrc=8, force_use_type3=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        _port(kw, GaussianBeam(diameter=10.0), mesh=object())


@pytest.mark.parametrize("polarized", [False, True])
def test_gains_unity_and_formula(polarized):
    """Unity gains are a no-op; arbitrary gains apply conj(g_i^b) g_j^a."""
    rng = np.random.default_rng(13)
    kw = _case(rng, nsrc=20, polarized=polarized, force_use_type3=True)
    sim_fn, params = _port(kw, GaussianBeam(diameter=10.0), differentiate_gains=True,
                           nufft_mode="type3")
    assert "gains" in params
    with torch.no_grad():
        base = sim_fn({"fluxes": params["fluxes"]}).numpy()
        unity = sim_fn(params).numpy()
    np.testing.assert_allclose(unity, base, rtol=0, atol=0)

    g = params["gains"].detach().numpy().copy()
    g[0] = rng.uniform(0.5, 1.5, g[0].shape)
    g[1] = rng.uniform(-0.5, 0.5, g[1].shape)
    with torch.no_grad():
        got = sim_fn({**params, "gains": torch.tensor(g)}).numpy()
    bls = [red[0] for red in get_pos_reds(kw["ants"], include_autos=True)]
    ant_index = {a: i for i, a in enumerate(kw["ants"])}
    gc = g[0] + 1j * g[1]
    want = base.copy()
    for b, (a0, a1) in enumerate(bls):
        i, j = ant_index[a0], ant_index[a1]
        if polarized:
            for fa in range(2):
                for fb in range(2):
                    want[:, :, fa, fb, b] *= np.conj(gc[i, :, fb, None]) * gc[j, :, fa, None]
        else:
            want[:, :, b] *= (np.conj(gc[i]) * gc[j])[:, None]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    jsim, jparams = _jax(kw, JGaussianBeam(diameter=10.0), differentiate_gains=True)
    _against_reference(sim_fn, {**params}, jsim, {**jparams, "gains": g}, 2)


def _phased_beams(base, gc):
    """One copy of ``base`` per antenna with its feeds times gc[k] (nfreq,
    feed)."""
    out = []
    for k in range(gc.shape[0]):
        data = np.array(base.data_array) * gc[k].T[None, :, :, None, None]
        out.append(GriddedBeam(data, base.axis1_array, base.axis2_array, base.freq_array,
                               beam_type="efield"))
    return out


@pytest.mark.parametrize("precision", [2, 1])
def test_gains_equal_phased_per_antenna_beams(precision, caplog):
    """Applying params['gains'] equals baking the same factors into each
    antenna's E-field beam, flipped baselines included; at precision 1, on
    five antennas (11 beam pairs), the list is auto-ranked, and the gains
    keep the pair routing's flip convention there."""
    rng = np.random.default_rng(15)
    nant = {2: 4, 1: 5}[precision]
    kw = _case(rng, nsrc=18, nfreq=2, ntimes=2, nant=nant, polarized=True,
               force_use_type3=True)
    kw["precision"] = precision
    base = GriddedBeam.from_function(GaussianBeam(diameter=11.0), n_az=73, n_za=37,
                                     freqs=tuple(kw["freqs"]))
    gc = (rng.uniform(0.6, 1.4, (nant, 2, 2)) * np.exp(1j * rng.uniform(-1.2, 1.2,
                                                                         (nant, 2, 2))))
    want = simulate_vis(beam=_phased_beams(base, gc), beam_idx=np.arange(nant),
                        telescope_loc=LOC, device="cpu", **kw)
    with caplog.at_level("INFO", logger="fftvis_tpu_torch.cuda.engine"):
        sim_fn, params = _port(kw, [base] * nant, beam_idx=np.arange(nant),
                               differentiate_gains=True)
    assert ("auto-rank:" in caplog.text) == (precision == 1)
    g = np.stack([gc.real, gc.imag])
    with torch.no_grad():
        got = sim_fn({**params, "gains": torch.tensor(g, dtype=params["gains"].dtype)}).numpy()
    assert _rel(got, want) <= {2: 1e-12, 1: GATE[1]}[precision]
    bls = [red[0] for red in get_pos_reds(kw["ants"], include_autos=True)]
    ant_index = {a: i for i, a in enumerate(kw["ants"])}
    assert any(ant_index[a0] > ant_index[a1] for a0, a1 in bls)


def test_gain_calibration_recovers_products():
    """Fitting gains against gain-corrupted data recovers g_i conj(g_j)."""
    rng = np.random.default_rng(14)
    kw = _case(rng, nsrc=16, nfreq=1, ntimes=3, nant=6, force_use_type3=True)
    sim_fn, params = _port(kw, GaussianBeam(diameter=10.0), differentiate_gains=True)
    g_true = params["gains"].detach().clone()
    g_true[0] += 0.2 * torch.tensor(rng.standard_normal(g_true[0].shape))
    g_true[1] += 0.2 * torch.tensor(rng.standard_normal(g_true[1].shape))
    fluxes = params["fluxes"].detach()
    with torch.no_grad():
        data = sim_fn({"fluxes": fluxes, "gains": g_true})
    x = params["gains"].detach().clone().requires_grad_()
    opt = torch.optim.Adam([x], lr=2e-2)
    for _ in range(500):
        opt.zero_grad()
        val = (sim_fn({"fluxes": fluxes, "gains": x}) - data).abs().pow(2).sum()
        val.backward()
        opt.step()
    assert float(val.detach()) < 1e-10
    gc_t = (g_true[0] + 1j * g_true[1]).numpy()
    gc_f = (x[0] + 1j * x[1]).detach().numpy()
    np.testing.assert_allclose(gc_f[:, None] * np.conj(gc_f[None, :]),
                               gc_t[:, None] * np.conj(gc_t[None, :]), rtol=0, atol=2e-3)


# ------------------------------------------- the paths, against the JAX package

@pytest.mark.parametrize("precision", [2, 1])
def test_exact_type1_fluxes_and_gains_match_reference(precision):
    """A hex lattice in auto mode: the exact type-1 product, polarized."""
    rng = np.random.default_rng(21)
    kw = dict(_case(rng, nsrc=30, polarized=True), ants=hex_array(3), precision=precision)
    sim_fn, params = _port(kw, GaussianBeam(diameter=10.0), differentiate_gains=True)
    jsim, jparams = _jax(kw, JGaussianBeam(diameter=10.0), differentiate_gains=True)
    _against_reference(sim_fn, params, jsim, jparams, precision)


def test_iquv_per_antenna_table_matches_reference():
    """An IQUV sky through stacked per-antenna tables (pair_rows and the
    table's adjoint) on forced type-3."""
    rng = np.random.default_rng(22)
    beams = [_gridded_pair(i, (1.0e8, 1.1e8), n_az=36, n_za=19) for i in range(3)]
    kw = _case(rng, nsrc=20, nant=5, polarized=True, stokes=True, force_use_type3=True)
    kw["beam_idx"] = np.array([0, 1, 2, 1, 0])
    sim_fn, params = _port(kw, [b[0] for b in beams], differentiate_beam=True,
                           differentiate_gains=True, nufft_mode="type3",
                           beam_spline_opts={"order": 3})
    jsim, jparams = _jax(kw, [b[1] for b in beams], differentiate_beam=True,
                         differentiate_gains=True, beam_spline_opts={"order": 3})
    _against_reference(sim_fn, params, jsim, jparams, 2)


@pytest.mark.parametrize("path", ["exact-type1", "type3"])
def test_one_beam_per_antenna_matches_reference(path):
    """Every antenna its own tabulated beam (7 antennas, 7 same-grid tables,
    ``beam_idx = arange(7)``), polarized, on the exact type-1 path of a hex
    lattice (``hex_array(2)``, Stokes I) and on forced type-3 (random
    positions, an IQUV sky): the forward and the flux, beam-table and gain
    gradients of the port against ``fftvis_tpu.build_differentiable_sim``
    from the same NumPy inputs, within ``_against_reference``'s gates of
    1e-9 of the largest entry (precision 2, values and each gradient)."""
    rng = np.random.default_rng(24)
    beams = [_gridded_pair(i, (1.0e8, 1.1e8), n_az=36, n_za=19) for i in range(7)]
    if path == "exact-type1":
        kw = dict(_case(rng, nsrc=24, nant=7, polarized=True), ants=hex_array(2))
        extra = {}
    else:
        kw = _case(rng, nsrc=20, nant=7, polarized=True, stokes=True, force_use_type3=True)
        extra = {"nufft_mode": "type3"}
    assert len(kw["ants"]) == 7
    kw["beam_idx"] = np.arange(7)
    sim_fn, params = _port(kw, [b[0] for b in beams], differentiate_beam=True,
                           differentiate_gains=True, **extra)
    assert set(params) == {"fluxes", "beam_table", "gains"}
    jsim, jparams = _jax(kw, [b[1] for b in beams], differentiate_beam=True,
                         differentiate_gains=True)
    before = type1_mod.products
    _against_reference(sim_fn, params, jsim, jparams, 2)
    # The exact type-1 product ran on the lattice, and not on type-3.
    assert (type1_mod.products > before) == (path == "exact-type1")


def test_shared_tabulated_beam_rows_matches_reference():
    """One shared tabulated beam, polarized: the fused beam_rows Function's
    sky gradient, on forced type-3 at precision 1."""
    rng = np.random.default_rng(23)
    beam, jbeam = _gridded_pair(0, (1.0e8, 1.1e8), n_az=36, n_za=19)
    kw = dict(_case(rng, nsrc=24, polarized=True, stokes=True, force_use_type3=True),
              precision=1)
    before = spread_mod.launches, interp_mod.launches
    sim_fn, params = _port(kw, beam, nufft_mode="type3", beam_spline_opts={"order": 3})
    jsim, jparams = _jax(kw, jbeam, beam_spline_opts={"order": 3})
    _against_reference(sim_fn, params, jsim, jparams, 1)
    assert (spread_mod.launches, interp_mod.launches) == before  # plain versions here


def test_beam_coefs_matches_reference():
    """User eigenbeams with beam_coefs (the basis contraction) and a
    differentiated eigenbeam table."""
    rng = np.random.default_rng(24)
    kw = _case(rng, nsrc=20, nant=4, nfreq=1, polarized=True, force_use_type3=True)
    beams = [_gridded_pair(i, kw["freqs"], n_az=36, n_za=19) for i in range(2)]
    coefs = rng.normal(size=(4, 2, 1)) + 1j * rng.normal(size=(4, 2, 1))
    sim_fn, params = _port(kw, [b[0] for b in beams], beam_coefs=coefs,
                           differentiate_beam=True, differentiate_gains=True)
    jsim, jparams = _jax(kw, [b[1] for b in beams], beam_coefs=coefs,
                         differentiate_beam=True, differentiate_gains=True)
    _against_reference(sim_fn, params, jsim, jparams, 2)


def test_banded_run_matches_reference(monkeypatch, caplog):
    """Horizon banding (8 times, 4096+ sources after the cull, small band
    blocks): the coherency follows the cull and the band permutation."""
    monkeypatch.setenv("FFTVIS_BAND_BLOCK", "128")
    rng = np.random.default_rng(25)
    nsrc = 4800
    kw = dict(_case(rng, nsrc=nsrc, ntimes=10, nfreq=1, nant=3), ants=hex_array(2, sep=14.6))
    kw["dec"] = np.arcsin(rng.uniform(-1, 1, nsrc))
    kw["times"] = JD0 + np.linspace(0, 1.0, 10)
    with caplog.at_level("INFO", logger="fftvis_tpu_torch.cuda.engine"):
        sim_fn, params = _port(kw, GaussianBeam(diameter=10.0))
    assert "horizon banding engaged" in caplog.text
    assert "horizon culling" in caplog.text
    jsim, jparams = _jax(kw, JGaussianBeam(diameter=10.0))
    _against_reference(sim_fn, params, jsim, jparams, 2)


def test_caches_hold_no_graph_and_no_parameter():
    """After a gradient step through a stacked per-antenna table, the
    engine's cached device inputs and stacked table carry no graph and are
    not the parameters; a second build hits the caches; the program run
    on the cached inputs builds no graph."""
    from fftvis_tpu_torch import CUDASimulationEngine, cache_stats, clear_caches
    from fftvis_tpu_torch.beams import interface
    from fftvis_tpu_torch.cuda import engine as engine_mod
    from fftvis_tpu_torch.wrapper import prepare_beam_list

    clear_caches()
    rng = np.random.default_rng(26)
    beams = [_gridded_pair(i, (1.0e8,), n_az=36, n_za=19)[0] for i in range(2)]
    kw = _case(rng, nsrc=12, nfreq=1, ntimes=1, nant=4, polarized=True)
    kw["beam_idx"] = np.array([0, 1, 1, 0])
    sim_fn, params = _port(kw, beams, differentiate_beam=True, differentiate_gains=True)
    loss = sim_fn(params).abs().pow(2).sum()
    loss.backward()
    assert all(p.grad is not None for p in params.values())
    stacks = [v.table for v in interface.STACK_CACHE.entries.values()]
    cached = [v for v in engine_mod.INPUT_CACHE.entries.values()] + stacks
    assert stacks and all(isinstance(t, torch.Tensor) for t in cached)
    for t in cached:
        assert not t.requires_grad and t.grad_fn is None
        assert all(t.data_ptr() != p.data_ptr() for p in params.values())
    misses = cache_stats()["input"][1]
    _port(kw, beams, differentiate_beam=True)
    assert cache_stats()["input"][1] == misses
    bl, idx = prepare_beam_list(beams, kw["freqs"], True, None, "x", 4, kw["beam_idx"])
    ekw = {k: v for k, v in kw.items() if k not in ("beam_idx",)}
    run, inputs, info = CUDASimulationEngine(device="cpu").simulate(
        beam_list=bl, beam_idx=idx, telescope_loc=LOC, return_program=True, **ekw)
    assert info["has_beam_table"] and inputs[info["beam_table_index"]] is stacks[0]
    assert run(*inputs).grad_fn is None


def test_lowrank_z_type3_matches_reference(caplog):
    """A non-coplanar array with type-3 forced: the low-rank-z executor's
    C*K-channel spread and interp and its z-mode contraction under
    autograd, against the JAX front-end (which plans the direct path at
    this size; both are exact to far below the gate at precision 2)."""
    rng = np.random.default_rng(27)
    ants = {k: np.array([v[0], v[1], rng.uniform(-2, 2)]) for k, v in hex_array(2).items()}
    kw = dict(_case(rng, nsrc=30, nfreq=1, polarized=True, stokes=True), ants=ants)
    with caplog.at_level("INFO"):
        sim_fn, params = _port(kw, GaussianBeam(diameter=10.0), differentiate_gains=True,
                               nufft_mode="type3")
    assert "low-rank-z" in caplog.text.lower() or "lowrank" in caplog.text.lower()
    jsim, jparams = _jax(kw, JGaussianBeam(diameter=10.0), differentiate_gains=True)
    _against_reference(sim_fn, params, jsim, jparams, 2)
