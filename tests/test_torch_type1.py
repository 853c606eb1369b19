"""The exact type-1 transform of gridded arrays: the port on the CPU vs
``fftvis_tpu`` and vs the exact float64 oracle.

- ``plan_type1_exact`` gives identical plan arrays;
- ``Type1ExactExecutor`` ``spread`` (a full block and a ragged one),
  ``gather`` and ``gather_padded`` against the JAX executor (1e-12 in
  float64, 1e-5 relative in float32), on the same lattice phases and
  weights;
- ``select_gridded_path`` and the gridded branch of ``plan_transform``
  decide as the JAX planner does: ES type-1 (the same plan arrays) under
  ``FFTVIS_TYPE1=es`` and past the 512^2-cell limit; ``FFTVIS_TYPE1=exact``
  forces the exact executor on both sides, past the limit too, and any
  value but auto/exact/es is refused;
- under ``FFTVIS_TYPE1=exact`` the port's ``simulate_vis`` gives the JAX
  package's result (1e-9 at precision 2);
- ``simulate_vis`` in ``auto`` mode on hex_array(3) -- a lattice, so the
  exact type-1 path -- with one shared beam and with distinct complex
  per-antenna variants of the committed beamfits asset (flipped baselines
  among them), unpolarized, polarized and with an IQUV sky, at both
  precisions: 1e-9 / 1e-4 against fftvis_tpu and 1e-5 / 1e-4 against the
  direct oracle, relative to max|V|.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fftvis_tpu import TelescopeLocation as JaxLocation
from fftvis_tpu import simulate_vis as jax_simulate_vis
from fftvis_tpu.beams import GaussianBeam as JaxGaussian
from fftvis_tpu.beams import io as jax_io
from fftvis_tpu.beams import synth as jax_synth
from fftvis_tpu.beams.interface import BeamInterface as JaxBeamInterface
from fftvis_tpu.beams.interface import prepare_beam_unpolarized as jax_unpolarized
from fftvis_tpu.nufft import transform as jax_transform
from fftvis_tpu.reference.direct_engine import DirectSimulationEngine
from fftvis_tpu.tpu import planning as jax_planning
from fftvis_tpu_torch import TelescopeLocation, simulate_vis
from fftvis_tpu_torch.beams import GaussianBeam, perturbed_variants, read_beamfits
from fftvis_tpu_torch.core.beams import plan_beam_pairs
from fftvis_tpu_torch.core.utils import get_pos_reds
from fftvis_tpu_torch.cuda import planning
from fftvis_tpu_torch.geometry import hex_array
from fftvis_tpu_torch.nufft import type1
from fftvis_tpu_torch.nufft.transform import Type1Executor
from fftvis_tpu_torch.utils import healpix_radec

ASSET = str(Path(__file__).resolve().parent / "data" / "structured_dipole_100MHz.beamfits")
SITE = (np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
VS_REFERENCE = {2: 1e-9, 1: 1e-4}
VS_ORACLE = {2: 1e-5, 1: 1e-4}
EXEC_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture(autouse=True)
def _pair_routing_on_both_sides(monkeypatch):
    # The engines' eigenbeam substitution of a per-antenna list (auto-rank,
    # test_torch_auto_rank.py) stays off: both sides run the pair routing.
    monkeypatch.setenv("FFTVIS_AUTO_RANK", "0")


def _modes(kind, rng):
    if kind == "hex":
        ants = hex_array(5)
        reds = [r[0] for r in get_pos_reds(ants)]
        from fftvis_tpu_torch.core.antenna_gridding import check_antpos_griddability
        _, gpos, _ = check_antpos_griddability(ants)
        m = np.array([gpos[j] - gpos[i] for i, j in reds]).T[:2]
        return np.round(m).astype(np.int64)
    if kind == "random":
        return rng.integers(-7, 12, (2, 40))
    return np.array([[0, 1, -3], [0, 0, 2]])  # few modes, unequal axes


@pytest.mark.parametrize("kind", ["hex", "random", "small"])
def test_plan_type1_exact_identical(kind):
    modes = _modes(kind, np.random.default_rng(0))
    got = type1.plan_type1_exact(modes)
    want = jax_transform.plan_type1_exact(modes)
    assert (got.d, got.nf, got.kmax, got.split, got.n_targets) == (
        want.d, want.nf, want.kmax, want.split, want.n_targets)
    assert np.array_equal(got.gather_idx, want.gather_idx)
    assert got.gather_idx.dtype == want.gather_idx.dtype


@pytest.mark.parametrize("n", [300, 37])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["hex", "small"])
def test_type1_executor_matches_reference(kind, dtype, n):
    rng = np.random.default_rng(1)
    modes = _modes(kind, rng)
    plan = type1.plan_type1_exact(modes)
    jex = jax_transform.Type1ExactExecutor(jax_transform.plan_type1_exact(modes))
    ex = type1.Type1ExactExecutor(plan, device="cpu")
    C = 8
    x = rng.uniform(-40.0, 40.0, (2, n))
    c = rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    got = ex.spread(torch.tensor(x, dtype=dtype), torch.tensor(c, dtype=cdt))
    jdt = np.float64 if dtype == torch.float64 else np.float32
    want = np.asarray(jex.spread(jnp.asarray(x.astype(jdt)),
                                 jnp.asarray(c.astype(np.complex128 if jdt == np.float64
                                                      else np.complex64))))
    scale = np.abs(want).max()
    assert got.shape == want.shape == (C,) + plan.nf
    assert np.abs(got.numpy() - want).max() <= EXEC_TOL[dtype] * scale
    # Accumulation into a carried grid: a second block adds.
    ex.spread(torch.tensor(x, dtype=dtype), torch.tensor(c, dtype=cdt), grid=got)
    assert np.abs(got.numpy() - 2 * want).max() <= 2 * EXEC_TOL[dtype] * scale
    # The gathers, on the reference's own grid.
    G = torch.tensor(want)
    m = plan.n_targets
    sel = np.arange(m)[::2]
    np.testing.assert_array_equal(ex.gather(G).numpy(), np.asarray(jex.gather(jnp.asarray(want))))
    np.testing.assert_array_equal(ex.gather(G, sel).numpy(),
                                  np.asarray(jex.gather(jnp.asarray(want), sel)))
    sel_pad = np.stack([np.arange(m)[:2], np.arange(m)[-2:]])  # (P = 2, m_max = 2)
    Gp = G.reshape(2, C // 2, *plan.nf)
    np.testing.assert_array_equal(
        ex.gather_padded(Gp, sel_pad).numpy(),
        np.asarray(jex.gather_padded(jnp.asarray(want).reshape(2, C // 2, *plan.nf), sel_pad)))


def _wide_lattice():
    """Antennas whose lattice is the separation grid but whose baselines
    reach 400 cells an axis: an exact mode grid past 512^2 cells."""
    sep = 14.6
    pts = [(0, 0), (1, 0), (0, 1), (400, 0), (0, 400)]
    return {i: np.array([a * sep, b * sep, 0.0]) for i, (a, b) in enumerate(pts)}


@pytest.mark.parametrize("case", ["auto", "direct", "exact refused", "es", "wide",
                                  "exact", "exact wide"])
def test_select_gridded_path_decisions(case, monkeypatch):
    ants = _wide_lattice() if case in ("wide", "exact wide") else hex_array(3)
    keys = list(ants)
    bls = [(keys[i], keys[j]) for i in range(len(keys)) for j in range(i, len(keys))]
    idx = np.arange(len(keys)) % 2
    pp = plan_beam_pairs(keys, bls, idx)
    flipped = np.zeros(len(bls), dtype=bool)
    for sel, fl in zip(pp.bls_idxs, pp.flipped):
        flipped[sel] = fl
    assert flipped.any()
    mode = "direct" if case == "direct" else "auto"
    if case == "es":
        monkeypatch.setenv("FFTVIS_TYPE1", "es")
    args = (ants, bls, np.array([1e8]), 1e-13, 2.0, 1e-6, False, flipped, len(bls), 100, 2,
            pp.npairs)
    if case == "exact refused":
        # FFTVIS_TYPE1 takes the JAX package's values, exact among them; any
        # other value is refused.
        monkeypatch.setenv("FFTVIS_TYPE1", "exacts")
        with pytest.raises(ValueError, match="expected 'auto', 'exact' or 'es'"):
            planning.plan_transform(mode, *args, device="cpu")
        return
    if case.startswith("exact"):
        # The JAX package's override past the exact path's checks (a mode
        # grid past 512^2 cells with "exact wide").
        monkeypatch.setenv("FFTVIS_TYPE1", "exact")
    want = jax_planning.plan_transform(mode, *args)
    got = planning.plan_transform(mode, *args, device="cpu")
    if case in ("es", "wide"):
        # ES type-1 on both sides (asked for, or past the exact path's
        # 512^2 cells): the same fine grid, kernel and gather tables.
        assert type(want.executor).__name__ == "Type1Executor"
        assert isinstance(got.executor, Type1Executor)
        gp, wp = got.executor.plan, want.executor.plan
        assert (got.mode, gp.nf, gp.d, gp.n_targets) == (want.mode, wp.nf, wp.d, wp.n_targets)
        assert (gp.kernel.w, gp.kernel.beta) == (wp.kernel.w, wp.kernel.beta)
        np.testing.assert_array_equal(gp.gather_idx, wp.gather_idx)
        np.testing.assert_array_equal(gp.gather_deconv, wp.gather_deconv)
        np.testing.assert_array_equal(got.lattice_matrix, want.lattice_matrix)
        return
    assert got.mode == want.mode
    np.testing.assert_array_equal(got.lattice_matrix, want.lattice_matrix)
    np.testing.assert_array_equal(got.rotation_matrix, want.rotation_matrix)
    if case == "direct":
        # Signed lattice modes: flipped baselines negated.
        np.testing.assert_array_equal(got.targets, want.targets)
        return
    assert isinstance(got.executor, type1.Type1ExactExecutor)
    assert type(want.executor).__name__ == "Type1ExactExecutor"
    gp, wp = got.executor.plan, want.executor.plan
    if case == "exact wide":
        assert int(np.prod(gp.nf)) > planning.DENSE_GRID_LIMIT
    assert (gp.nf, gp.kmax, gp.split) == (wp.nf, wp.kmax, wp.split)
    np.testing.assert_array_equal(gp.gather_idx, wp.gather_idx)


def _inputs(iquv=False, **extra):
    ants = hex_array(3)
    reds = [red[0] for red in get_pos_reds(ants, include_autos=True)]
    ra, dec = healpix_radec(8)
    rng = np.random.default_rng(0)
    flux = rng.uniform(0.1, 1.0, (ra.size, 1))
    if iquv:
        flux = np.stack([flux, *(rng.uniform(-0.05, 0.05, (3, ra.size, 1)))], axis=-1)
    return dict(
        ants=ants, ra=ra, dec=dec, fluxes=flux, freqs=np.array([1.0e8]),
        times=2459863.2 + np.linspace(0, 0.01, 2),
        baselines=reds + [(j, i) for (i, j) in reds[1:8]],
        **extra,
    )


def _oracle(jbeams, kw):
    polarized = kw.get("polarized", False)
    beam_list = [JaxBeamInterface(b) for b in jbeams]
    if not polarized:
        beam_list = [jax_unpolarized(b) for b in beam_list]
    return DirectSimulationEngine().simulate(
        beam_list=beam_list, telescope_loc=JaxLocation(*SITE), **kw)


def _check(got, want, oracle, precision, shape):
    scale = np.abs(oracle).max()
    assert got.shape == want.shape == oracle.shape == shape
    assert got.dtype == want.dtype
    assert np.abs(got - want).max() / scale <= VS_REFERENCE[precision]
    assert np.abs(got - oracle).max() / scale <= VS_ORACLE[precision]


@pytest.mark.parametrize("precision", [2, 1])
def test_shared_beam_auto_mode_takes_exact_type1(precision):
    """One analytic beam on a lattice: ``auto`` takes the exact type-1
    path on both sides."""
    kw = _inputs(precision=precision)
    got = simulate_vis(beam=GaussianBeam(diameter=14.0), telescope_loc=TelescopeLocation(*SITE),
                       device="cpu", **kw)
    want = jax_simulate_vis(beam=JaxGaussian(diameter=14.0), telescope_loc=JaxLocation(*SITE),
                            **kw)
    _check(got, want, _oracle([JaxGaussian(diameter=14.0)], kw), precision,
           (1, 2, len(kw["baselines"])))


def test_forced_exact_matches_reference(monkeypatch):
    """``FFTVIS_TYPE1=exact`` on a small lattice: the exact type-1 path on
    both sides, where the port used to refuse the value."""
    monkeypatch.setenv("FFTVIS_TYPE1", "exact")
    kw = _inputs(precision=2)
    got = simulate_vis(beam=GaussianBeam(diameter=14.0), telescope_loc=TelescopeLocation(*SITE),
                       device="cpu", **kw)
    want = jax_simulate_vis(beam=JaxGaussian(diameter=14.0), telescope_loc=JaxLocation(*SITE),
                            **kw)
    _check(got, want, _oracle([JaxGaussian(diameter=14.0)], kw), 2,
           (1, 2, len(kw["baselines"])))


@pytest.mark.parametrize("precision", [2, 1])
@pytest.mark.parametrize("sky,pattern", [("polarized", "cycle"), ("polarized", "skewed"),
                                         ("unpolarized", "cycle"), ("iquv", "cycle")])
def test_per_antenna_auto_mode_matches_reference_and_oracle(sky, pattern, precision):
    """Distinct complex variants through ``simulate_vis``: the exact type-1
    path, its padded gather ('cycle', 3 beams) or its per-pair gather
    ('skewed', 5 beams: antennas 0-3 one each, the rest the fifth)."""
    polarized = sky != "unpolarized"
    nbeams = 3 if pattern == "cycle" else 5
    kw = _inputs(iquv=sky == "iquv", precision=precision, polarized=polarized)
    nant = len(kw["ants"])
    if pattern == "cycle":
        kw["beam_idx"] = np.arange(nant) % nbeams
    else:
        kw["beam_idx"] = np.full(nant, nbeams - 1)
        kw["beam_idx"][: nbeams - 1] = np.arange(nbeams - 1)
    beams = perturbed_variants(read_beamfits(ASSET), nbeams)
    jbeams = jax_synth.perturbed_variants(jax_io.read_beamfits(ASSET), nbeams)
    got = simulate_vis(beam=beams, telescope_loc=TelescopeLocation(*SITE), device="cpu", **kw)
    want = jax_simulate_vis(beam=jbeams, telescope_loc=JaxLocation(*SITE), **kw)
    nbl = len(kw["baselines"])
    _check(got, want, _oracle(jbeams, kw), precision,
           (1, 2, 2, 2, nbl) if polarized else (1, 2, nbl))
