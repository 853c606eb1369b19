"""ES type-1 on the engine's gridded path: the port on the CPU against
``fftvis_tpu`` and the exact float64 oracle.

- ``plan_type1`` gives the JAX package's plan arrays (d = 1, 2, 3; sigma 2
  and 1.25), and ``Type1Plan.from_reference`` carries a JAX plan over;
- ``Type1Executor`` ``spread`` (a full block and a ragged one, accumulated
  into a carried grid), ``gather`` and ``gather_padded`` against the JAX
  executor on one plan (1e-12 in float64, 1e-5 relative in float32);
- ``simulate_vis`` under ``FFTVIS_TYPE1=es`` against the JAX package's
  ``simulate_vis`` (1e-9 of max|V| at precision 2, 1e-4 at precision 1)
  and the oracle ``DirectSimulationEngine`` (1e-5 / 1e-4): one analytic
  beam; polarized per-antenna beams on the padded gather ('cycle') and the
  per-pair gather ('skewed'); ``beam_coefs``; auto-rank; a horizon-banded
  day; ``async_fetch``; and, in ``auto`` mode without the variable, the
  5-antenna lattice whose exact mode grid passes 512^2 cells;
- the engine's source block on an ES plan counts the transform's rows
  only (no fine-grid cells a source, which the exact executor's outer
  factor has);
- ``build_differentiable_sim`` under ``FFTVIS_TYPE1=es``: values and the
  gradients of fluxes and gains against ``jax.grad`` (1e-9).
"""

import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fftvis_tpu
from fftvis_tpu import TelescopeLocation as JaxLocation
from fftvis_tpu import simulate_vis as jax_simulate_vis
from fftvis_tpu.beams import GaussianBeam as JaxGaussian
from fftvis_tpu.beams import io as jax_io
from fftvis_tpu.beams import synth as jax_synth
from fftvis_tpu.beams.gridded import GriddedBeam as JaxGridded
from fftvis_tpu.beams.interface import BeamInterface as JaxBeamInterface
from fftvis_tpu.beams.interface import prepare_beam_unpolarized as jax_unpolarized
from fftvis_tpu.nufft import transform as jax_transform
from fftvis_tpu.reference.direct_engine import DirectSimulationEngine
from fftvis_tpu_torch import (
    TelescopeLocation,
    build_differentiable_sim,
    clear_caches,
    simulate_vis,
)
from fftvis_tpu_torch.autodiff import params_from_reference
from fftvis_tpu_torch.beams import GaussianBeam, perturbed_variants, read_beamfits
from fftvis_tpu_torch.beams.gridded import GriddedBeam
from fftvis_tpu_torch.core.antenna_gridding import check_antpos_griddability
from fftvis_tpu_torch.core.utils import get_pos_reds
from fftvis_tpu_torch.cuda import engine, planning
from fftvis_tpu_torch.geometry import hex_array
from fftvis_tpu_torch.nufft import spread as spread_mod
from fftvis_tpu_torch.nufft import type1
from fftvis_tpu_torch.nufft.transform import Type1Executor, Type1Plan, plan_type1
from fftvis_tpu_torch.utils import healpix_radec

ASSET = str(Path(__file__).resolve().parent / "data" / "structured_dipole_100MHz.beamfits")
SITE = (np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
VS_REFERENCE = {2: 1e-9, 1: 1e-4}
VS_ORACLE = {2: 1e-5, 1: 1e-4}
EXEC_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture(autouse=True)
def _es(monkeypatch):
    # ES type-1 on both sides, the pair routing unless a test turns
    # auto-rank on, and cold caches.
    monkeypatch.setenv("FFTVIS_TYPE1", "es")
    monkeypatch.setenv("FFTVIS_AUTO_RANK", "0")
    clear_caches()
    yield
    clear_caches()


def _lattice_modes():
    ants = hex_array(5)
    _, gpos, _ = check_antpos_griddability(ants)
    m = np.array([gpos[j] - gpos[i] for i, j in (r[0] for r in get_pos_reds(ants))]).T[:2]
    return np.round(m).astype(np.int64)


def _wide_lattice():
    sep = 14.6
    pts = [(0, 0), (1, 0), (0, 1), (400, 0), (0, 400)]
    return {i: np.array([a * sep, b * sep, 0.0]) for i, (a, b) in enumerate(pts)}


# ---------------------------------------------------------------- the plan

@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("eps,sigma", [(1e-6, 2.0), (1e-13, 2.0), (1e-6, 1.25)])
def test_plan_type1_copy_identical(d, eps, sigma):
    rng = np.random.default_rng(d)
    modes = rng.integers(-30, 31, (d, 60)) if d != 2 else _lattice_modes()
    got = plan_type1(modes, eps, sigma)
    want = jax_transform.plan_type1(modes, eps, sigma)
    assert (got.d, got.nf, got.n_targets) == (want.d, want.nf, want.n_targets)
    assert (got.kernel.w, got.kernel.beta, got.kernel.sigma) == (
        want.kernel.w, want.kernel.beta, want.kernel.sigma)
    for a, b in ((got.gather_idx, want.gather_idx), (got.gather_deconv, want.gather_deconv)):
        assert a.dtype == b.dtype and not a.flags.writeable
        np.testing.assert_array_equal(a, b)
    carried = Type1Plan.from_reference(want)
    assert carried.nf == got.nf and carried.kernel == got.kernel
    np.testing.assert_array_equal(carried.gather_deconv, got.gather_deconv)


# ------------------------------------------------------------ the executor

@pytest.mark.parametrize("n", [300, 37])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_es_executor_matches_reference(dtype, n):
    rng = np.random.default_rng(1)
    modes = _lattice_modes()
    eps = 1e-12 if dtype == torch.float64 else 1e-6
    jplan = jax_transform.plan_type1(modes, eps)
    ex = Type1Executor(Type1Plan.from_reference(jplan), device="cpu")
    jex = jax_transform.Type1Executor(jplan)
    C = 4
    x = rng.uniform(-40.0, 40.0, (2, n))
    c = rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    jdt = np.float64 if dtype == torch.float64 else np.float32
    got = ex.spread(torch.tensor(x, dtype=dtype), torch.tensor(c, dtype=cdt))
    want = np.asarray(jex.spread(jnp.asarray(x.astype(jdt)), jnp.asarray(c.astype(cdt.__repr__()
                                                                                   .split(".")[-1]))))
    scale = np.abs(want).max()
    assert got.shape == want.shape == (C,) + jplan.nf
    assert np.abs(got.numpy() - want).max() <= EXEC_TOL[dtype] * scale
    # Accumulation into a carried grid: a second block adds.
    ex.spread(torch.tensor(x, dtype=dtype), torch.tensor(c, dtype=cdt), grid=got)
    assert np.abs(got.numpy() - 2 * want).max() <= 2 * EXEC_TOL[dtype] * scale
    # The transform and the gathers, on the reference's own grid.
    G = ex.transform(torch.tensor(want))
    JG = jex.transform(jnp.asarray(want))
    gscale = np.abs(np.asarray(JG)).max()
    np.testing.assert_allclose(G.numpy(), np.asarray(JG), rtol=0, atol=EXEC_TOL[dtype] * gscale)
    JG = jnp.asarray(G.numpy())
    m = jplan.n_targets
    sel = np.arange(m)[::2]
    for got_g, want_g in ((ex.gather(G), jex.gather(JG)),
                          (ex.gather(G, sel), jex.gather(JG, sel))):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-15, atol=0)
    sel_pad = np.stack([np.arange(m)[:3], np.arange(m)[-3:]])  # (P = 2, m_max = 3)
    np.testing.assert_allclose(
        ex.gather_padded(G.reshape(2, C // 2, *jplan.nf), sel_pad).numpy(),
        np.asarray(jex.gather_padded(JG.reshape(2, C // 2, *jplan.nf), sel_pad)),
        rtol=1e-15, atol=0)


def test_source_block_counts_no_fine_grid():
    """The exact executor's (block, nmy * nmx) outer factor sizes its block;
    the ES executor's fine grid is no per-source temporary."""
    bls = _lattice_modes()
    es_plan = planning.SimPlan("type1", Type1Executor(plan_type1(bls, 1e-13), device="cpu"),
                               None, np.eye(3), np.eye(3))
    xplan = planning.SimPlan("type1", type1.Type1ExactExecutor(type1.plan_type1_exact(bls),
                                                               device="cpu"),
                             None, np.eye(3), np.eye(3))
    C = 720
    got = engine.source_block(es_plan, C, bls.shape[1], 180, True, 8, torch.complex128)
    assert got == min(engine.SOURCE_BLOCK, engine.BLOCK_BYTES // (2 * C * 16))
    exact = engine.source_block(xplan, C, bls.shape[1], 180, True, 8, torch.complex128)
    assert exact == min(engine.SOURCE_BLOCK, engine.BLOCK_BYTES // (
        2 * C * 16 + int(np.prod(xplan.executor.plan.nf)) * 16))
    # A fine grid past a block's budget a source leaves the ES block whole.
    wide = plan_type1(np.array([[0, 900], [0, 700]]), 1e-13)
    assert int(np.prod(wide.nf)) * 16 > engine.BLOCK_BYTES // engine.SOURCE_BLOCK
    wide_plan = planning.SimPlan("type1", Type1Executor(wide, device="cpu"), None,
                                 np.eye(3), np.eye(3))
    assert engine.source_block(wide_plan, 4, 2, 1, False, 0, torch.complex128) == \
        engine.SOURCE_BLOCK


# ---------------------------------------------------------------- simulate_vis

def _inputs(ants=None, nside=8, iquv=False, ntimes=2, **extra):
    ants = hex_array(3) if ants is None else ants
    reds = [red[0] for red in get_pos_reds(ants, include_autos=True)]
    ra, dec = healpix_radec(nside)
    rng = np.random.default_rng(0)
    flux = rng.uniform(0.1, 1.0, (ra.size, 1))
    if iquv:
        flux = np.stack([flux, *(rng.uniform(-0.05, 0.05, (3, ra.size, 1)))], axis=-1)
    return dict(
        ants=ants, ra=ra, dec=dec, fluxes=flux, freqs=np.array([1.0e8]),
        times=2459863.2 + np.linspace(0, 0.01, ntimes),
        baselines=reds + [(j, i) for (i, j) in reds[1:8]],
        **extra,
    )


def _oracle(jbeams, kw):
    kw = {k: v for k, v in kw.items() if k not in ("beam_coefs", "async_fetch")}
    polarized = kw.get("polarized", False)
    beam_list = [JaxBeamInterface(b) for b in jbeams]
    if not polarized:
        beam_list = [jax_unpolarized(b) for b in beam_list]
    return DirectSimulationEngine().simulate(
        beam_list=beam_list, telescope_loc=JaxLocation(*SITE), **kw)


def _es_run(beams, jbeams, kw, caplog, oracle=True):
    """The port and the JAX package under ES type-1 (the port's ES path
    asserted by its planner's log line), and the oracle; returns the port's
    result and its two relative errors."""
    with caplog.at_level(logging.INFO, logger="fftvis_tpu_torch.cuda.planning"):
        got = simulate_vis(beam=beams, telescope_loc=TelescopeLocation(*SITE), device="cpu",
                           **kw)
    assert "Gridded path: ES type-1" in caplog.text
    want = jax_simulate_vis(beam=jbeams, telescope_loc=JaxLocation(*SITE),
                            **{k: v for k, v in kw.items() if k != "async_fetch"})
    if kw.get("async_fetch"):
        assert got.done()
        got = got.result()
    assert got.shape == want.shape and got.dtype == want.dtype
    ref = _oracle(jbeams if isinstance(jbeams, list) else [jbeams], kw) if oracle else want
    scale = np.abs(ref).max()
    return got, np.abs(got - want).max() / scale, np.abs(got - ref).max() / scale


@pytest.mark.parametrize("precision", [2, 1])
def test_analytic_beam_matches_reference_and_oracle(precision, caplog):
    kw = _inputs(precision=precision)
    got, vs_ref, vs_oracle = _es_run(GaussianBeam(diameter=14.0), JaxGaussian(diameter=14.0),
                                     kw, caplog)
    assert got.shape == (1, 2, len(kw["baselines"]))
    assert vs_ref <= VS_REFERENCE[precision] and vs_oracle <= VS_ORACLE[precision]


@pytest.mark.parametrize("precision", [2, 1])
@pytest.mark.parametrize("sky,pattern", [("polarized", "cycle"), ("polarized", "skewed"),
                                         ("iquv", "cycle")])
def test_per_antenna_matches_reference_and_oracle(sky, pattern, precision, caplog):
    """Distinct complex variants of the committed beamfits: the padded
    gather ('cycle', 3 beams) or the per-pair gather ('skewed', 5 beams:
    antennas 0-3 one each, the rest the fifth), flipped baselines among
    them."""
    nbeams = 3 if pattern == "cycle" else 5
    kw = _inputs(iquv=sky == "iquv", precision=precision, polarized=True)
    nant = len(kw["ants"])
    if pattern == "cycle":
        kw["beam_idx"] = np.arange(nant) % nbeams
    else:
        kw["beam_idx"] = np.full(nant, nbeams - 1)
        kw["beam_idx"][: nbeams - 1] = np.arange(nbeams - 1)
    beams = perturbed_variants(read_beamfits(ASSET), nbeams)
    jbeams = jax_synth.perturbed_variants(jax_io.read_beamfits(ASSET), nbeams)
    got, vs_ref, vs_oracle = _es_run(beams, jbeams, kw, caplog)
    assert got.shape == (1, 2, 2, 2, len(kw["baselines"]))
    assert vs_ref <= VS_REFERENCE[precision] and vs_oracle <= VS_ORACLE[precision]


def test_beam_coefs_matches_reference(caplog):
    """User eigenbeams with ``beam_coefs``: the basis contraction after the
    ES gather (the k <= l list with transpose reuse)."""
    kw = _inputs(precision=2, polarized=True)
    rng = np.random.default_rng(4)
    shape = (len(kw["ants"]), 2, 1)
    kw["beam_coefs"] = rng.uniform(0.5, 1.5, shape) + 0.1j * rng.uniform(-1, 1, shape)
    beams = [GaussianBeam(diameter=12.0), GaussianBeam(diameter=14.0)]
    jbeams = [JaxGaussian(diameter=12.0), JaxGaussian(diameter=14.0)]
    _, vs_ref, _ = _es_run(beams, jbeams, kw, caplog, oracle=False)
    assert vs_ref <= VS_REFERENCE[2]


def test_auto_rank_matches_reference(caplog, monkeypatch):
    """A polarized list of 7 complex Gaussian tables at precision 1: both
    engines swap it for the same eigenbeams, then the ES type-1."""
    monkeypatch.delenv("FFTVIS_AUTO_RANK")
    jbeams = []
    for i in range(7):
        gb = JaxGridded.from_function(JaxGaussian(diameter=14.0 + 0.02 * i), n_az=91, n_za=46,
                                      freqs=(1.0e8,))
        jbeams.append(JaxGridded(np.asarray(gb.data_array) * np.exp(1j * (0.05 + 0.03 * i)),
                                 gb.axis1_array, gb.axis2_array, gb.freq_array,
                                 beam_type="efield", feeds=gb.feeds))
    beams = [GriddedBeam(b.data_array, b.axis1_array, b.axis2_array, b.freq_array, b.beam_type,
                         feeds=b.feeds) for b in jbeams]
    ants = hex_array(2, sep=14.6)
    keys = list(ants)
    kw = dict(_inputs(ants=ants, nside=4, precision=1, polarized=True, beam_idx=np.arange(7)),
              baselines=[(keys[i], keys[j]) for i in range(7) for j in range(i, 7)])
    caplog.set_level(logging.INFO)
    _, vs_ref, _ = _es_run(beams, jbeams, kw, caplog, oracle=False)
    assert sum("auto-rank" in r.getMessage() and "compressed" in r.getMessage()
               for r in caplog.records) == 2  # once in each package
    assert vs_ref <= VS_REFERENCE[1]


def test_banded_day_matches_reference(caplog, monkeypatch):
    """Horizon banding (10 times over a day, 4800 sources, band blocks of
    128): the ES spread runs each time's active blocks only."""
    monkeypatch.setenv("FFTVIS_BAND_BLOCK", "128")
    rng = np.random.default_rng(7)
    n = 4800
    kw = dict(ants=hex_array(3, sep=14.6), ra=rng.uniform(0, 2 * np.pi, n),
              dec=np.arcsin(rng.uniform(-1, 1, n)), fluxes=rng.uniform(0.1, 1.0, (n, 1)),
              freqs=np.array([1e8]), times=2459863.2 + np.linspace(0, 1.0, 10), precision=2)
    caplog.set_level(logging.INFO)
    spread_mod_calls = []
    real = Type1Executor.spread

    def count(self, x, c, grid=None):
        spread_mod_calls.append(x.shape[1])
        return real(self, x, c, grid)

    monkeypatch.setattr(Type1Executor, "spread", count)
    _, vs_ref, _ = _es_run(GaussianBeam(diameter=14.0), JaxGaussian(diameter=14.0), kw, caplog,
                           oracle=False)
    assert "horizon banding engaged" in caplog.text
    nblocks = -(-n // 128)
    assert 0 < len(spread_mod_calls) < 10 * nblocks
    assert vs_ref <= VS_REFERENCE[2]


def test_async_fetch_matches_reference(caplog):
    kw = _inputs(precision=2, async_fetch=True)
    _, vs_ref, vs_oracle = _es_run(GaussianBeam(diameter=14.0), JaxGaussian(diameter=14.0), kw,
                                   caplog)
    assert vs_ref <= VS_REFERENCE[2] and vs_oracle <= VS_ORACLE[2]


@pytest.mark.parametrize("precision", [2, 1])
def test_wide_lattice_auto_mode_takes_es(precision, caplog, monkeypatch):
    """The 5-antenna lattice with (400, 0) and (0, 400): an exact mode grid
    past 512^2 cells, so ``auto`` mode takes ES type-1 on both sides.

    At precision 1 the port forms the grid coordinates from a float64
    coordinate chain and meets the oracle's gate; the JAX package's float32
    chain on the CPU misses it here (3.1e-4 of max|V|: |k| reaches 400,
    where ~1e-7 relative rounding of the source phases is ~1e-3 rad), so
    the port is held to the oracle alone there."""
    monkeypatch.delenv("FFTVIS_TYPE1")
    kw = _inputs(ants=_wide_lattice(), nside=4, precision=precision)
    got, vs_ref, vs_oracle = _es_run(GaussianBeam(diameter=14.0), JaxGaussian(diameter=14.0),
                                     kw, caplog)
    assert vs_oracle <= VS_ORACLE[precision]
    if precision == 2:
        assert vs_ref <= VS_REFERENCE[precision]


# ---------------------------------------------------------------- autodiff

def test_differentiable_sim_matches_jax_grad():
    """Fluxes and gains through the ES spread (SpreadFunction), the FFT and
    the deconvolved gather, against ``jax.grad`` of the same loss."""
    rng = np.random.default_rng(21)
    nsrc = 30
    loc = TelescopeLocation(*SITE)
    kw = dict(ants=hex_array(3), fluxes=rng.uniform(0.1, 1.0, (nsrc, 2)),
              ra=rng.uniform(0, 2 * np.pi, nsrc),
              dec=np.clip(SITE[0] + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2),
              freqs=np.array([1.0e8, 1.1e8]), times=2459863.2 + np.linspace(0, 0.02, 2),
              polarized=True, precision=2)
    before = spread_mod.adjoint_launches
    sim, params = build_differentiable_sim(beam=GaussianBeam(diameter=10.0), telescope_loc=loc,
                                           device="cpu", differentiate_gains=True, **kw)
    jsim, jparams = fftvis_tpu.build_differentiable_sim(
        beam=JaxGaussian(diameter=10.0), telescope_loc=JaxLocation(*SITE),
        differentiate_gains=True, **kw)
    jp = {k: np.asarray(v, dtype=np.float64) for k, v in jparams.items()}
    p = params_from_reference(jp, params)
    want = np.asarray(jsim({k: jnp.asarray(v) for k, v in jp.items()}))
    got = sim(p).detach().numpy()
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    data = 0.9 * want
    jg = jax.grad(lambda q: jnp.sum(jnp.abs(jsim(q) - data) ** 2))(
        {k: jnp.asarray(v) for k, v in jp.items()})
    loss = (sim(p) - torch.as_tensor(data)).abs().pow(2).sum()
    grads = torch.autograd.grad(loss, list(p.values()))
    for key, g in zip(p, grads):
        want_g = np.asarray(jg[key])
        assert np.abs(g.numpy() - want_g).max() <= 1e-9 * np.abs(want_g).max(), key
    assert spread_mod.adjoint_launches == before  # the plain adjoint on the CPU
