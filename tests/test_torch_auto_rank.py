"""Auto-rank, the automatic rank compression of per-antenna beam lists: the
port's ``core/auto_rank.py`` and its engine branch on the CPU against
``fftvis_tpu``.

The cases of the JAX package's ``tests/test_auto_rank.py`` on the same
seeded NumPy inputs (hex_array(2) with all its i <= j baselines, 120
sources, (46, 91) tables):

- ``plan_auto_rank`` on the raw tables gives the JAX package's K, channel
  list, list kind and residual (the SVD's input is the same arrays), and
  declines where it declines; a decline is cached, so the SVD runs once;
- with auto-rank engaged on both sides, the engines log the same
  substitution and the port equals fftvis_tpu within 1e-9 of max|V|
  (precision 2 at eps 1e-6, where auto-rank engages); the port equals its
  own ``FFTVIS_AUTO_RANK=0`` pair routing within 2e-6 (the eps / 8 table
  residual; plus 2 eps on type-3 with flipped baselines, where the two
  routings plan fine grids of other sizes), including the structured
  complex family with flipped baselines, whose flips the basis path must
  feed-transpose;
- it never engages at the float64 default eps, nor under
  ``FFTVIS_AUTO_RANK=0``.

Each engine case runs on the direct path, type-3 and hex_array(2)'s exact
type-1 path. On a CUDA card (marked ``cuda``; skipped without one),
``pair_rows`` and ``beam_eval`` are held to their plain versions at the
shapes the basis path gives them: the eigenbeam row's K = 6 complex stack
(P = 21; K = 8 and P = 36 where its beams are evaluated in float32) and its
(91, 180, 8 K) table, the north star's K = 7 ordered list (P = 49), and a
real-Jones K = 7 stack (P = 28).
"""

import logging

import numpy as np
import pytest
import torch

from fftvis_tpu import TelescopeLocation as JaxLocation
from fftvis_tpu.beams import GaussianBeam as JaxGaussian
from fftvis_tpu.beams import GriddedBeam as JaxGridded
from fftvis_tpu.beams import synth as jax_synth
from fftvis_tpu.core import auto_rank as jax_auto_rank
from fftvis_tpu.tpu.engine import TPUSimulationEngine
from fftvis_tpu.wrapper import prepare_beam_list as jax_prepare_beam_list
from fftvis_tpu_torch import CUDASimulationEngine, TelescopeLocation, cache_stats, clear_caches
from fftvis_tpu_torch.beams import GaussianBeam, GriddedBeam
from fftvis_tpu_torch.beams import eval as eval_mod
from fftvis_tpu_torch.core import auto_rank
from fftvis_tpu_torch.core.coherency import build_coherency
from fftvis_tpu_torch.geometry import hex_array
from fftvis_tpu_torch.wrapper import prepare_beam_list

SITE = (np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JD0 = 2459863.2
FREQS = np.array([1.0e8, 1.05e8])
TIMES = JD0 + np.array([0.0, 1.0 / 60 / 24])
VS_REFERENCE = 1e-9
VS_PAIR_ROUTING = 2e-6
MODES = {"direct": "direct", "type3": "type3", "type1": "auto"}
KERNEL_TOL = {torch.float32: 2e-6, torch.float64: 1e-12}


@pytest.fixture(autouse=True)
def _auto_rank_on(monkeypatch):
    monkeypatch.delenv("FFTVIS_AUTO_RANK", raising=False)
    clear_caches()
    yield
    clear_caches()


def _port(jbeams):
    """The port's GriddedBeams on the JAX tables' arrays."""
    return [GriddedBeam(b.data_array, b.axis1_array, b.axis2_array, b.freq_array, b.beam_type,
                        feeds=b.feeds) for b in jbeams]


def _gaussians(n=7, complex_phase=False):
    """(port, fftvis_tpu) Gaussian tables of slightly different widths: a
    near-low-rank real family, or with ``complex_phase`` a complex one."""
    jbeams = []
    for i in range(n):
        gb = JaxGridded.from_function(JaxGaussian(diameter=14.0 + 0.02 * i), n_az=91, n_za=46,
                                      freqs=(1.0e8,))
        if complex_phase:
            gb = JaxGridded(np.asarray(gb.data_array) * np.exp(1j * (0.05 + 0.03 * i)),
                            gb.axis1_array, gb.axis2_array, gb.freq_array, beam_type="efield",
                            feeds=gb.feeds)
        jbeams.append(gb)
    return _port(jbeams), jbeams


def _structured(nbeams=8):
    """(port, fftvis_tpu) exact rank-3 complex mixes of three structured
    variants (the JAX test_structured_complex_family_with_flips family)."""
    rng = np.random.default_rng(3)
    base = jax_synth.structured_dipole_beam(n_az=90, n_za=46)
    modes = jax_synth.perturbed_variants(base, 3)
    jbeams = []
    for _ in range(nbeams):
        c = rng.standard_normal(3) + 1j * rng.standard_normal(3)
        data = np.ascontiguousarray(sum(c[k] * modes[k].data_array for k in range(3)))
        jbeams.append(JaxGridded(data.astype(np.complex128), base.axis1_array, base.axis2_array,
                                 base.freq_array, beam_type="efield", feeds=base.feeds))
    return _port(jbeams), jbeams


def _inputs(iquv=False, extra_baselines=()):
    ants = hex_array(2, sep=14.6)
    keys = list(ants)
    rng = np.random.default_rng(0)
    n = 120
    ra = rng.uniform(0, 2 * np.pi, n)
    dec = rng.uniform(np.deg2rad(-60.0), 0.0, n)
    if iquv:
        flux = np.zeros((n, FREQS.size, 4))
        flux[:, :, 0] = rng.uniform(0.5, 1.0, (n, FREQS.size))
        flux[:, :, 1:3] = rng.uniform(-0.2, 0.2, (n, FREQS.size, 2))
        flux[:, :, 3] = rng.uniform(-0.1, 0.1, (n, FREQS.size))
    else:
        flux = rng.uniform(0.1, 1.0, (n, FREQS.size))
    bls = [(keys[i], keys[j]) for i in range(7) for j in range(i, 7)] + list(extra_baselines)
    return dict(ants=ants, fluxes=flux, ra=ra, dec=dec, freqs=FREQS, times=TIMES,
                polarized=True, precision=2, eps=1e-6, baselines=bls)


def _substitutions(caplog, package):
    """The engine's auto-rank lines of one package, without the logger."""
    return [r.getMessage() for r in caplog.records
            if r.name in (f"{package}.tpu.engine", f"{package}.cuda.engine")
            and "auto-rank" in r.getMessage() and "compressed" in r.getMessage()]


def _port_run(path, beams, kw, beam_idx):
    bl, idx = prepare_beam_list(beams, kw["freqs"], True, None, "x", len(kw["ants"]), beam_idx)
    return CUDASimulationEngine(nufft_mode=MODES[path], device="cpu").simulate(
        beam_list=bl, beam_idx=idx, telescope_loc=TelescopeLocation(*SITE), **kw)


def _jax_run(path, jbeams, kw, beam_idx):
    bl, idx = jax_prepare_beam_list(jbeams, kw["freqs"], True, None, "x", len(kw["ants"]),
                                    beam_idx)
    return TPUSimulationEngine(nufft_mode=MODES[path]).simulate(
        beam_list=bl, beam_idx=idx, telescope_loc=JaxLocation(*SITE), **kw)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _vs_pair_routing(path, flips: bool, eps: float) -> float:
    """The bound of auto-rank against the pair routing: the eps / 8 table
    residual, and on type-3 with flipped baselines the two transforms'
    errors too (each within eps of the exact sum): the pair routing's
    signed targets give its fine grid another size than the basis path's
    unsigned ones."""
    return VS_PAIR_ROUTING + (2 * eps if path == "type3" and flips else 0.0)


# ------------------------------------------------------------ the planner

def _family(nbeam, rank, seed=0, nza=46, naz=91, phase=0.0):
    """(port, fftvis_tpu) beams spanning an exact rank-``rank`` family."""
    rng = np.random.default_rng(seed)
    az = np.linspace(0, 2 * np.pi, naz, endpoint=False)
    za = np.linspace(0, np.pi, nza)
    basis = rng.standard_normal((rank, 2, 2, 1, nza, naz))
    mix = rng.uniform(0.5, 1.5, (nbeam, rank))
    jbeams = [JaxGridded(np.tensordot(mix[b], basis, axes=1) * np.exp(1j * phase * b), az, za,
                         np.array([1.0e8]), "efield") for b in range(nbeam)]
    return _port(jbeams), jbeams


def _plan_cases():
    low = _family(8, 2)
    mixed = _family(4, 2)
    jother = JaxGridded(np.asarray(mixed[1][0].data_array)[..., ::2],
                        mixed[1][0].axis1_array[::2], mixed[1][0].axis2_array,
                        np.array([1.0e8]), "efield")
    return {
        "exact low rank": (low, dict(tol=1e-9, npairs=36, allow_sym=True)),
        "no gain": (_family(4, 3), dict(tol=1e-9, npairs=10, allow_sym=True)),
        "mixed grids": ((mixed[0][:3] + _port([jother]), mixed[1][:3] + [jother]),
                        dict(tol=1e-9, npairs=100, allow_sym=True)),
        "analytic": (([GaussianBeam(diameter=14.0 + i) for i in range(4)],
                      [JaxGaussian(diameter=14.0 + i) for i in range(4)]),
                     dict(tol=1e-9, npairs=100, allow_sym=True)),
        "complex tables": (_family(6, 2, seed=1, phase=0.1),
                           dict(tol=1e-9, npairs=21, allow_sym=True)),
        "polarized sky": (_family(6, 2, seed=2), dict(tol=1e-9, npairs=21, allow_sym=False)),
        "gaussian sweep": (_gaussians(7), dict(tol=1.25e-7, npairs=28, allow_sym=True)),
    }


PLAN_CASES = ["exact low rank", "no gain", "mixed grids", "analytic", "complex tables",
              "polarized sky", "gaussian sweep"]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_auto_rank_matches_reference(case):
    (beams, jbeams), kw = _plan_cases()[case]
    plan = auto_rank.plan_auto_rank(beams, **kw)
    want = jax_auto_rank.plan_auto_rank(jbeams, **kw)
    if want is None:
        assert plan is None
        return
    assert plan is not None
    assert (plan.K, plan.kl_pairs, plan.kl_sym, plan.residual, plan.tol) == (
        want.K, want.kl_pairs, want.kl_sym, want.residual, want.tol)
    expect = {"exact low rank": (2, True), "complex tables": (2, False),
              "polarized sky": (2, False)}.get(case)
    if expect is not None:
        assert (plan.K, plan.kl_sym) == expect
    table = np.stack([np.asarray(e.data_array).ravel() for e in plan.eigenbeams])
    jtable = np.stack([np.asarray(e.data_array).ravel() for e in want.eigenbeams])
    rec, jrec = plan.coefs @ table, want.coefs @ jtable
    assert np.abs(rec - jrec).max() <= 1e-12 * np.abs(jrec).max()
    raw = np.stack([np.asarray(b.data_array).ravel() for b in beams])
    assert np.abs(rec - raw).max() <= kw["tol"] * np.abs(raw).max()


def test_decline_is_cached(monkeypatch):
    """A full-rank family declines once: the next call hits the cached
    decline and does not stack and decompose the tables again."""
    rng = np.random.default_rng(5)
    az, za = np.linspace(0, 2 * np.pi, 17), np.linspace(0, np.pi / 2, 9)
    beams = [GriddedBeam(rng.normal(size=(2, 2, 1, za.size, az.size)), az, za,
                         np.array([1.0e8]), "efield") for _ in range(4)]
    calls = []
    real = auto_rank._plan_uncached
    monkeypatch.setattr(auto_rank, "_plan_uncached",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for _ in range(3):
        assert auto_rank.plan_auto_rank(beams, 1e-12, npairs=100, allow_sym=True) is None
    assert len(calls) == 1
    assert cache_stats()["autorank"] == (2, 1)


# ------------------------------------------------------------ the engine

@pytest.mark.parametrize("path", list(MODES))
@pytest.mark.parametrize("case", ["real family", "complex family iquv", "reversed baselines"])
def test_auto_rank_matches_reference_and_pair_routing(case, path, caplog, monkeypatch):
    """Both engines substitute the same eigenbeams (real tables and a
    Stokes-I sky: the symmetric list; complex tables and an IQUV sky: the
    ordered one), and agree; the port's result is its pair routing's within
    the residual."""
    caplog.set_level(logging.INFO)
    beams, jbeams = _gaussians(7, complex_phase=case == "complex family iquv")
    keys = list(hex_array(2, sep=14.6))
    extra = [(keys[1], keys[0]), (keys[5], keys[2]), (keys[6], keys[3])]
    kw = _inputs(iquv=case == "complex family iquv",
                 extra_baselines=extra if case == "reversed baselines" else ())
    idx = np.arange(7)
    got = _port_run(path, beams, kw, idx)
    want = _jax_run(path, jbeams, kw, idx)
    port_lines, jax_lines = _substitutions(caplog, "fftvis_tpu_torch"), _substitutions(
        caplog, "fftvis_tpu")
    assert len(port_lines) == 1 and port_lines == jax_lines
    kind = "ordered" if case == "complex family iquv" else "symmetric"
    assert f"{kind} channel list" in port_lines[0]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _rel(got, want) <= VS_REFERENCE
    monkeypatch.setenv("FFTVIS_AUTO_RANK", "0")
    pairs = _port_run(path, beams, kw, idx)
    assert _rel(got, pairs) <= _vs_pair_routing(path, case == "reversed baselines", kw["eps"])
    assert len(_substitutions(caplog, "fftvis_tpu_torch")) == 1


@pytest.mark.parametrize("path", list(MODES))
def test_structured_complex_family_with_flips(path, caplog, monkeypatch):
    """An exact rank-3 complex mix of structured variants, beam_idx wrapping
    so that many baselines are stored flipped: the basis path must give
    their feed transpose, as the pair routing's convention (the conjugate
    without a feed swap) does -- 5e-2 off otherwise."""
    caplog.set_level(logging.INFO)
    beams, jbeams = _structured(8)
    kw = _inputs()
    kw.update(fluxes=kw["fluxes"][:, :1], freqs=FREQS[:1])
    idx = (np.arange(7) * 5) % 8
    got = _port_run(path, beams, kw, idx)
    want = _jax_run(path, jbeams, kw, idx)
    lines = _substitutions(caplog, "fftvis_tpu_torch")
    assert len(lines) == 1 and lines == _substitutions(caplog, "fftvis_tpu")
    assert "K=3" in lines[0] and "ordered channel list" in lines[0]
    assert _rel(got, want) <= VS_REFERENCE
    monkeypatch.setenv("FFTVIS_AUTO_RANK", "0")
    pairs = _port_run(path, beams, kw, idx)
    assert _rel(got, pairs) <= _vs_pair_routing(path, True, kw["eps"])


@pytest.mark.parametrize("path", list(MODES))
@pytest.mark.parametrize("case", ["fp64 eps", "kill switch"])
def test_auto_rank_stays_off(case, path, caplog, monkeypatch):
    """No substitution at the float64 default eps (1e-13), nor under
    FFTVIS_AUTO_RANK=0: the result is the pair routing's, bit for bit."""
    caplog.set_level(logging.INFO)
    beams, _ = _gaussians(7)
    kw = _inputs()
    if case == "fp64 eps":
        kw.pop("eps")
    else:
        monkeypatch.setenv("FFTVIS_AUTO_RANK", "0")
    got = _port_run(path, beams, kw, np.arange(7))
    assert _substitutions(caplog, "fftvis_tpu_torch") == []
    assert cache_stats()["autorank"] == (0, 0)
    monkeypatch.setenv("FFTVIS_AUTO_RANK", "0")
    np.testing.assert_array_equal(got, _port_run(path, beams, kw, np.arange(7)))


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", ["eigen row K=6 P=21", "float32-rank eigen row K=8 P=36",
                                   "north star K=7 P=49", "real Jones K=7 P=28"])
def test_cuda_pair_rows_basis_shapes(cuda_device, shape, dtype):
    K = int(shape.split("K=")[1].split()[0])
    ordered = shape.startswith("north")
    ch_shape = (2, 2) if shape.startswith("real") else (2, 2, 2)
    pairs = np.array([(k, l) for k in range(K) for l in range(0 if ordered else k, K)])
    assert len(pairs) == int(shape.split("P=")[1])
    rng = np.random.default_rng(K)
    n = 4096
    evals = rng.normal(size=(n, K * int(np.prod(ch_shape))))
    mask = (rng.uniform(size=n) < 0.5).astype(float)
    for iquv in (False, True):
        stokes = rng.uniform(0.1, 1.0, (n, 1))
        sky = (build_coherency(np.stack([stokes, *rng.uniform(-0.05, 0.05, (3, n, 1))],
                                        axis=-1), True)[:, 0] if iquv else stokes[:, 0])
        args = (torch.tensor(evals, dtype=dtype, device=cuda_device),
                torch.tensor(pairs[:, 0], dtype=torch.int32, device=cuda_device),
                torch.tensor(pairs[:, 1], dtype=torch.int32, device=cuda_device),
                torch.tensor(sky, dtype=eval_mod.COMPLEX[dtype] if iquv else dtype,
                             device=cuda_device),
                torch.tensor(mask, dtype=dtype, device=cuda_device))
        before = eval_mod.pair_launches
        got = eval_mod.pair_rows(*args, ch_shape, False, iquv)
        assert eval_mod.pair_launches == before + 1
        want = eval_mod.pair_rows_plain(*args, ch_shape, False, iquv)
        assert (got - want).abs().max().item() <= KERNEL_TOL[dtype] * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [6, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_beam_eval_eigen_row_stack(cuda_device, dtype, K):
    """The eigen row's stack: K complex Jones tables of (91, 180)."""
    rng = np.random.default_rng(8)
    data = torch.tensor(rng.normal(size=(91, 180, 8 * K)), dtype=dtype, device=cuda_device)
    y = torch.tensor(rng.uniform(0, 90, 4096), dtype=dtype, device=cuda_device)
    x = torch.tensor(rng.uniform(0, 180, 4096), dtype=dtype, device=cuda_device)
    got = eval_mod.beam_eval(data, y, x, order=1, wrap_x=True)
    want = eval_mod.beam_eval_plain(data, y, x, order=1, wrap_x=True)
    assert (got - want).abs().max().item() <= KERNEL_TOL[dtype] * want.abs().max().item()
