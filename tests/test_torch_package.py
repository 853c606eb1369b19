"""Package-level checks of the PyTorch port.

- ``import fftvis_tpu_torch`` pulls in neither jax nor fftvis_tpu;
- the NumPy host modules the port copies give exactly the arrays of the
  originals, and its tensor evaluators match the JAX ones;
- the kernel wrappers refuse what the kernels do not take, and the slice
  refuses what it leaves out (ES type-1, eigenbeam coefficients, meshes,
  3D arrays, beam-table upsampling) with ``NotImplementedError``, an
  asynchronous call at dispatch;
- on a CUDA card (marked ``cuda``; skipped without one), each CUDA kernel
  matches its plain torch version and counts its launches.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fftvis_tpu.beams.analytic import AiryBeam as JaxAiry
from fftvis_tpu.beams.analytic import GaussianBeam as JaxGaussian
from fftvis_tpu.beams.analytic import UniformBeam as JaxUniform
from fftvis_tpu.beams.analytic import bessel_j1 as jax_bessel_j1
from fftvis_tpu.coords import erfa_lite as jax_erfa
from fftvis_tpu.coords.rotation import SourceRotation as JaxRotation
from fftvis_tpu.coords.rotation import enu_to_az_za as jax_enu_to_az_za
from fftvis_tpu.core import antenna_gridding as jax_grid
from fftvis_tpu.core import beams as jax_core_beams
from fftvis_tpu.core import coherency as jax_coh
from fftvis_tpu.core import utils as jax_utils
from fftvis_tpu.geometry import hex_array as jax_hex_array
from fftvis_tpu.utils import healpix as jax_healpix
from fftvis_tpu_torch import TelescopeLocation, simulate_vis
from fftvis_tpu_torch.beams import (
    AiryBeam,
    GaussianBeam,
    ShortDipoleBeam,
    UniformBeam,
    beam_from_reference,
    structured_dipole_beam,
)
from fftvis_tpu_torch.beams.analytic import bessel_j1
from fftvis_tpu_torch.coords import erfa_lite
from fftvis_tpu_torch.coords.rotation import SourceRotation, enu_to_az_za
from fftvis_tpu_torch.core import antenna_gridding, coherency
from fftvis_tpu_torch.core import beams as core_beams
from fftvis_tpu_torch.core import utils as core_utils
from fftvis_tpu_torch.geometry import hex_array
from fftvis_tpu_torch.nufft import interp as interp_mod
from fftvis_tpu_torch.nufft import spread as spread_mod
from fftvis_tpu_torch.utils import healpix

REPO = Path(__file__).resolve().parent.parent
JD = 2459863.2 + np.linspace(0, 0.3, 4)
SITE = (np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)


def test_import_pulls_in_no_jax():
    code = (
        "import sys, fftvis_tpu_torch, fftvis_tpu_torch.cuda.engine, "
        "fftvis_tpu_torch._build; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'fftvis_tpu')); print(bad); sys.exit(bool(bad))"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# ---------------------------------------------------------------- host copies

def test_erfa_lite_copy_identical():
    loc = TelescopeLocation(*SITE)
    jloc = jax_erfa.TelescopeLocation(*SITE)
    assert np.array_equal(erfa_lite.icrs_to_enu_matrices(JD, loc),
                          jax_erfa.icrs_to_enu_matrices(JD, jloc))
    assert np.array_equal(erfa_lite.aberration_velocities(JD),
                          jax_erfa.aberration_velocities(JD))
    ra, dec = np.linspace(0, 6, 50), np.linspace(-1.5, 1.5, 50)
    assert np.array_equal(erfa_lite.radec_to_icrs_vectors(ra, dec),
                          jax_erfa.radec_to_icrs_vectors(ra, dec))


@pytest.mark.parametrize("nside", [1, 8, 64])
def test_healpix_copy_identical(nside):
    for a, b in zip(healpix.healpix_radec(nside), jax_healpix.healpix_radec(nside)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("args", [(3, 14.6, 0), (11, 14.6, 2), (5, 10.0, 1)])
def test_geometry_and_baseline_copies_identical(args):
    n, sep, outriggers = args
    ants = hex_array(n, sep=sep, outriggers=outriggers)
    jants = jax_hex_array(n, sep=sep, outriggers=outriggers)
    assert list(ants) == list(jants)
    assert all(np.array_equal(ants[k], jants[k]) for k in ants)
    if n <= 5:
        assert core_utils.get_pos_reds(ants) == jax_utils.get_pos_reds(jants)
    rng = np.random.default_rng(n)
    tilted = np.array(list(ants.values())) + np.array([0, 0, 1]) * rng.normal(0, 0.5, (len(ants), 1))
    assert np.array_equal(core_utils.get_plane_to_xy_rotation_matrix(tilted),
                          jax_utils.get_plane_to_xy_rotation_matrix(tilted))
    got, want = (antenna_gridding.check_antpos_griddability(ants),
                 jax_grid.check_antpos_griddability(jants))
    assert got[0] == want[0]
    assert np.array_equal(got[2], want[2])


def test_beam_pair_routing_copy_identical():
    bls = [(0, 1), (2, 1), (3, 3), (1, 4)]
    got = core_beams.plan_beam_pairs(list(range(5)), bls, np.array([0, 1, 0, 1, 2]))
    want = jax_core_beams.plan_beam_pairs(list(range(5)), bls, np.array([0, 1, 0, 1, 2]))
    assert got.pairs == want.pairs
    for a, b in zip(got.bls_idxs + got.flipped, want.bls_idxs + want.flipped):
        assert np.array_equal(a, b)


def test_source_rotation_and_cull_identical():
    ra, dec = healpix.healpix_radec(16)
    rot = SourceRotation(ra, dec, JD[:2], TelescopeLocation(*SITE))
    jrot = JaxRotation(ra, dec, JD[:2], jax_erfa.TelescopeLocation(*SITE))
    assert np.array_equal(rot.cull_never_visible(), jrot.cull_never_visible())
    for name in ("matrices", "aberration", "eq_vectors"):
        assert np.array_equal(getattr(rot, name), getattr(jrot, name))


def test_coherency_and_az_za_match_reference():
    rng = np.random.default_rng(3)
    flux = rng.uniform(0.1, 1, (20, 3))
    assert np.array_equal(coherency.build_coherency(flux, False),
                          jax_coh.build_coherency(flux, False))
    e, n = rng.uniform(-0.7, 0.7, (2, 100))
    az, za = enu_to_az_za(torch.tensor(e), torch.tensor(n))
    jaz, jza = jax_enu_to_az_za(e, n)
    np.testing.assert_allclose(az.numpy(), jaz, rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(za.numpy(), jza, rtol=1e-15, atol=1e-15)
    p, f = rng.uniform(0, 1, (2, 100))
    rows = coherency.apparent_coherency_rows(torch.tensor(p), torch.tensor(p), torch.tensor(f))
    want = jax_coh.apparent_coherency_rows(jnp.asarray(p), jnp.asarray(p), jnp.asarray(f),
                                           False, False)
    np.testing.assert_allclose(rows.numpy(), np.asarray(want), rtol=1e-15)


def test_analytic_beams_match_reference():
    za = np.linspace(0, np.pi / 2, 200)
    x = np.linspace(-30, 30, 601)
    np.testing.assert_allclose(bessel_j1(torch.tensor(x)).numpy(), jax_bessel_j1(x),
                               rtol=1e-13, atol=1e-15)
    for beam, jbeam in ((GaussianBeam(diameter=14.0), JaxGaussian(diameter=14.0)),
                        (AiryBeam(diameter=14.0), JaxAiry(diameter=14.0)),
                        (UniformBeam(), JaxUniform())):
        got = beam.power(None, torch.tensor(za), 1.1e8).numpy()
        want = np.asarray(jbeam.power(jnp.zeros(200), jnp.asarray(za), 1.1e8))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
        assert type(beam_from_reference(jbeam)) is type(beam)


# ------------------------------------------------------------- refusals

def _spread_args(rdt=torch.float32, cdt=torch.complex64, n=8, nf=(16, 16)):
    return (torch.rand(n, dtype=rdt), torch.rand(n, dtype=rdt),
            torch.ones((1, n), dtype=cdt), torch.zeros((1,) + nf, dtype=cdt))


@pytest.mark.parametrize("case", ["dtype", "mixed", "shape", "width", "layout"])
def test_spread_wrapper_refuses(case):
    uy, ux, w, g = _spread_args()
    if case == "dtype":
        uy, ux = uy.half(), ux.half()
    elif case == "mixed":
        w = w.to(torch.complex128)
    elif case == "shape":
        w = torch.ones((1, 5), dtype=torch.complex64)
    elif case == "layout":
        g = torch.zeros((1, 16, 32), dtype=torch.complex64)[:, :, ::2]
    width = 17 if case == "width" else 4
    with pytest.raises((TypeError, ValueError)):
        spread_mod.spread(uy, ux, w, g, width, 9.0)


@pytest.mark.parametrize("case", ["dtype", "index", "shape", "layout"])
def test_interp_wrapper_refuses(case):
    G = torch.zeros((1, 16, 16), dtype=torch.complex64)
    iy = torch.zeros((5, 4), dtype=torch.int32)
    vy = torch.ones((5, 4), dtype=torch.float32)
    ix, vx = iy.clone(), vy.clone()
    if case == "dtype":
        vy = vy.double()
    elif case == "index":
        iy = iy.long()
    elif case == "shape":
        ix = torch.zeros((5, 3), dtype=torch.int32)
    elif case == "layout":
        G = torch.zeros((1, 16, 32), dtype=torch.complex64)[:, :, ::2]
    with pytest.raises((TypeError, ValueError)):
        interp_mod.interp(G, iy, ix, vy, vx)


@pytest.mark.parametrize("case", ["polarized", "beam_idx", "beams", "beam_coefs",
                                  "tabulated", "mesh", "async_fetch", "3d"])
def test_slice_refuses_what_it_leaves_out(case, monkeypatch):
    rng = np.random.default_rng(0)
    ants = {i: np.array([*rng.uniform(-50, 50, 2), 0.0]) for i in range(4)}
    kw = dict(ants=ants, fluxes=rng.uniform(0.1, 1, (6, 1)),
              ra=rng.uniform(0, 6, 6), dec=rng.uniform(-1, 0, 6),
              freqs=np.array([1e8]), times=np.array([2459863.2]),
              beam=GaussianBeam(diameter=14.0),
              telescope_loc=TelescopeLocation(*SITE), device="cpu")
    if case in ("3d", "async_fetch"):
        # async_fetch: an asynchronous call refuses at dispatch, not at
        # result(), what the slice leaves out.
        kw["ants"] = {i: np.array([*rng.uniform(-50, 50, 2), rng.uniform(-5, 5)])
                      for i in range(5)}
        kw["force_use_type3"] = True
        kw["async_fetch"] = case == "async_fetch"
    elif case == "polarized":
        # Per-antenna polarized beams on a lattice with ES type-1 asked
        # for: ES type-1 is not ported.
        monkeypatch.setenv("FFTVIS_TYPE1", "es")
        kw.update(ants=hex_array(2), polarized=True,
                  beam=[ShortDipoleBeam(), GaussianBeam(diameter=14.0)],
                  beam_idx=np.arange(7) % 2)
    elif case == "tabulated":
        # The opt-in table upsampling of a cubic tabulated beam.
        monkeypatch.setenv("FFTVIS_BEAM_UPSAMPLE", "2")
        kw.update(beam=structured_dipole_beam(n_az=24, n_za=10),
                  beam_spline_opts={"order": 3})
    elif case == "beam_idx":
        # Per-antenna beams on a lattice whose exact mode grid passes 512^2
        # cells: only ES type-1 would take it.
        sep = 14.6
        pts = [(0, 0), (1, 0), (0, 1), (400, 0), (0, 400)]
        kw.update(ants={i: np.array([a * sep, b * sep, 0.0]) for i, (a, b) in enumerate(pts)},
                  beam=[GaussianBeam(diameter=14.0), GaussianBeam(diameter=12.0)],
                  beam_idx=np.array([0, 1, 0, 1, 0]))
    elif case == "beams":
        # A beam list as an eigenbeam basis.
        kw.update(beam=[GaussianBeam(diameter=14.0)] * 2, beam_coefs=np.ones((4, 2, 1)))
    else:
        kw[case] = {"beam_coefs": np.ones((4, 1, 1)), "mesh": object()}[case]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        simulate_vis(**kw)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rdt,cdt,tol", [(torch.float32, torch.complex64, 1e-5),
                                         (torch.float64, torch.complex128, 1e-12)])
def test_cuda_spread_matches_plain(cuda_device, rdt, cdt, tol):
    rng = np.random.default_rng(0)
    nf, n, w, beta = (200, 168), 3000, 8, 18.4
    # Uniform sources plus some at exactly nf (the wrap edge).
    uy = np.concatenate([rng.uniform(0, nf[0], n - 2), [nf[0], 0.0]])
    ux = np.concatenate([rng.uniform(0, nf[1], n - 2), [0.0, nf[1]]])
    c = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    args = [torch.tensor(a, dtype=rdt, device=cuda_device) for a in (uy, ux)]
    wts = torch.tensor(c, dtype=cdt, device=cuda_device)
    before = spread_mod.launches
    got = spread_mod.spread(*args, wts, torch.zeros((3,) + nf, dtype=cdt, device=cuda_device), w, beta)
    assert spread_mod.launches == before + 1
    want = spread_mod.spread_plain(*args, wts, torch.zeros_like(got), w, beta)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("rdt,cdt,tol", [(torch.float32, torch.complex64, 1e-5),
                                         (torch.float64, torch.complex128, 1e-12)])
def test_cuda_interp_matches_plain(cuda_device, rdt, cdt, tol):
    rng = np.random.default_rng(1)
    nf, m, w = (200, 168), 5000, 8
    G = torch.tensor(rng.normal(size=(2,) + nf) + 1j * rng.normal(size=(2,) + nf),
                     dtype=cdt, device=cuda_device)
    iy = torch.tensor(rng.integers(0, nf[0], (m, w)), dtype=torch.int32, device=cuda_device)
    ix = torch.tensor(rng.integers(0, nf[1], (m, w)), dtype=torch.int32, device=cuda_device)
    vy, vx = (torch.tensor(rng.uniform(0, 1, (m, w)), dtype=rdt, device=cuda_device)
              for _ in range(2))
    runs = torch.tensor(interp_mod.footprint_runs(iy.cpu().numpy(), ix.cpu().numpy()),
                        device=cuda_device)
    before = interp_mod.launches
    got = interp_mod.interp(G, iy, ix, vy, vx, runs=runs)
    assert interp_mod.launches == before + 1
    want = interp_mod.interp_plain(G, iy, ix, vy, vx)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("w", [2, 5, 8, 14, 16])
@pytest.mark.parametrize("rdt,cdt,tol", [(torch.float32, torch.complex64, 1e-5),
                                         (torch.float64, torch.complex128, 1e-12)])
@pytest.mark.parametrize("repeats", [False, True])
def test_cuda_interp_order_matches_plain(cuda_device, rdt, cdt, tol, w, repeats):
    """Every template width, with tables in a permuted visiting order.
    With ``repeats``, targets share 40 footprints and the tables are sorted
    by footprint, so runs are long (cut at 32 rows) and take the kernel's
    shared-memory form; some rows of a footprint differ from it in the last
    tap column only, which must end a run. Without, every run is one row."""
    rng = np.random.default_rng(w)
    nf, m, C = (120, 136), 3001, 4
    G = torch.tensor(rng.normal(size=(C,) + nf) + 1j * rng.normal(size=(C,) + nf),
                     dtype=cdt, device=cuda_device)
    iy_np = rng.integers(0, nf[0], (m, w))
    ix_np = rng.integers(0, nf[1], (m, w))
    if repeats:
        pick = rng.integers(0, 40, m)
        iy_np, ix_np = iy_np[pick], ix_np[pick]
        alt = rng.random(m) < 0.3  # same first cell, another last column
        ix_np[alt, w - 1] = (ix_np[alt, w - 1] + 1) % nf[1]
    vy, vx = (torch.tensor(rng.uniform(0, 1, (m, w)), dtype=rdt, device=cuda_device)
              for _ in range(2))
    iy, ix = (torch.tensor(a, dtype=torch.int32, device=cuda_device) for a in (iy_np, ix_np))
    want = interp_mod.interp_plain(G, iy, ix, vy, vx)
    if repeats:
        perm = np.lexsort(np.concatenate([iy_np, ix_np], axis=1).T[::-1]).astype(np.int32)
        runs = torch.tensor(interp_mod.footprint_runs(iy_np[perm], ix_np[perm]),
                            device=cuda_device)
        assert (runs.diff() >= interp_mod.RUN_CAP).any()
    else:
        perm = rng.permutation(m).astype(np.int32)
        runs = torch.tensor(interp_mod.footprint_runs(iy_np[perm], ix_np[perm]),
                            device=cuda_device)
        assert (runs.diff() == 1).all()
    rows = torch.tensor(perm, dtype=torch.long, device=cuda_device)
    got = interp_mod.interp(G, iy[rows].contiguous(), ix[rows].contiguous(),
                            vy[rows].contiguous(), vx[rows].contiguous(),
                            order=rows.to(torch.int32), runs=runs)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["no runs", "runs out of range", "order out of range"])
def test_cuda_interp_bad_tables(cuda_device, case):
    """A CUDA call without runs raises; runs and an order with values out
    of range give wrong values but no access out of bounds."""
    rng = np.random.default_rng(5)
    nf, m, w = (64, 72), 500, 8
    G = torch.tensor(rng.normal(size=(2,) + nf) + 1j * rng.normal(size=(2,) + nf),
                     dtype=torch.complex64, device=cuda_device)
    iy = torch.tensor(rng.integers(0, nf[0], (m, w)), dtype=torch.int32, device=cuda_device)
    ix = torch.tensor(rng.integers(0, nf[1], (m, w)), dtype=torch.int32, device=cuda_device)
    vy, vx = (torch.tensor(rng.uniform(0, 1, (m, w)), dtype=torch.float32, device=cuda_device)
              for _ in range(2))
    runs = torch.arange(m + 1, dtype=torch.int32, device=cuda_device)
    order = torch.arange(m, dtype=torch.int32, device=cuda_device)
    if case == "no runs":
        with pytest.raises(ValueError, match="runs"):
            interp_mod.interp(G, iy, ix, vy, vx, order=order)
        return
    if case == "runs out of range":
        runs = torch.tensor([-7, m // 2, 3, m + 1000], dtype=torch.int32, device=cuda_device)
    else:
        order[::3] += 10 * m
        order[1::3] = -order[1::3] - 1
    got = interp_mod.interp(G, iy, ix, vy, vx, order=order, runs=runs)
    torch.cuda.synchronize()
    assert got.shape == (2, m)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [2, 7, 8, 14, 16])
@pytest.mark.parametrize("rdt,cdt,tol", [(torch.float32, torch.complex64, 1e-5),
                                         (torch.float64, torch.complex128, 1e-12)])
def test_cuda_spread_dense_and_zero_sources(cuda_device, rdt, cdt, tol, w):
    """Every template width; sources packed into one small patch (many
    atomics on each cell), half of them with all-zero weights."""
    rng = np.random.default_rng(w)
    nf, n, C = (96, 80), 2000, 4
    uy = rng.uniform(40, 56, n)
    ux = np.concatenate([rng.uniform(0, 16, n - 1), [nf[1]]])  # the wrap edge too
    c = rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
    c[:, ::2] = 0
    args = [torch.tensor(a, dtype=rdt, device=cuda_device) for a in (uy, ux)]
    wts = torch.tensor(c, dtype=cdt, device=cuda_device)
    beta = 2.3 * w
    got = spread_mod.spread(*args, wts, torch.zeros((C,) + nf, dtype=cdt, device=cuda_device),
                            w, beta)
    want = spread_mod.spread_plain(*args, wts, torch.zeros_like(got), w, beta)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= tol * scale
