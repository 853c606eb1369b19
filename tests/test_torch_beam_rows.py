"""The fused source-block rows of a tabulated beam vs the JAX package.

``PreparedBeam.rows`` of a tabulated beam is ``beam_rows``, which on CPU
tensors is ``beam_rows_plain``. Both are held to the JAX package's own
composition for one shared beam, what its engine's ``source_block_weights``
computes: ``fftvis_tpu.beams.interface.prepare_beam(...).evaluate(az, za,
fv, fi)``, then ``fftvis_tpu.core.coherency.apparent_coherency_rows(e, e,
flux, polarized, polarized_sky)``, the complex cast and ``* mask``. Same
NumPy inputs, made from a seed, on both sides:

- the three epilogues: power (feed ``y``), Jones x Stokes I, Jones x IQUV,
  the Jones ones on a complex and on a real efield table;
- orders 1 and 3; azimuth wrapped (a full-circle grid) and clamped (a
  half-circle grid);
- points on the azimuth seam, on the last za row and below the horizon
  (mask 0), and about a quarter of the rest masked;
- tolerances relative to max|ref|: float32 2e-6 (the port interpolates a
  float32 table, the JAX package its float64 one), float64 1e-12 (one
  algorithm). In float64 at order 1 the points at or beyond the last za
  row (and, clamped, the last az column) are masked, as the horizon masks
  za = pi/2 in a simulation: there the JAX gather's float64 clip reads row
  ``ny-2`` (ROADMAP section 3).

Also: ``run_program`` gives the same visibilities through the fused rows as
through ``evaluate`` + ``apparent_coherency_rows``; the entry points
default to ``cuda``; the wrapper refuses what the kernel does not take. On
a CUDA card (marked ``cuda``; skipped without one) the kernel is held to
the plain version and counts its launches, and the interpolation-only
``beam_eval`` kernel, which shares its tap code, is held to its plain
version.
"""

import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fftvis_tpu.beams import gridded as jax_gridded
from fftvis_tpu.beams import interface as jax_interface
from fftvis_tpu.core import coherency as jax_coh
from fftvis_tpu_torch import CUDASimulationEngine, TelescopeLocation, simulate_vis
from fftvis_tpu_torch.beams import (
    BeamInterface,
    GriddedBeam,
    PreparedBeam,
    ShortDipoleBeam,
    prepare_beam,
    prepare_beam_unpolarized,
    read_beamfits,
)
from fftvis_tpu_torch.beams import eval as eval_mod
from fftvis_tpu_torch.beams.interp import spline_prefilter_2d
from fftvis_tpu_torch.core import coherency
from fftvis_tpu_torch.core.utils import get_pos_reds
from fftvis_tpu_torch.cuda import engine as engine_mod
from fftvis_tpu_torch.geometry import hex_array
from fftvis_tpu_torch.nufft.transform import Type3Executor
from fftvis_tpu_torch.utils import healpix_radec

TOL = {torch.float32: 2e-6, torch.float64: 1e-12}
CDT = {torch.float32: np.complex64, torch.float64: np.complex128}
FREQS = np.array([1.05e8, 1.15e8])
NZA, NAZ = 19, 24
EPILOGUES = ("power", "jones-I", "jones-iquv")
# The Jones epilogues on a real efield table (2 x 2 real channels).
REAL_TABLE = ("jones-I-real", "jones-iquv-real")
ASSET = str(Path(__file__).resolve().parent / "data" / "structured_dipole_100MHz.beamfits")
SITE = (np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)


def _beams(wrap: bool, real: bool = False, seed: int = 0):
    """(port, fftvis_tpu) two-frequency efield beams from one NumPy table,
    complex or real."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(2, 2, 2, NZA, NAZ))
    if not real:
        data = data + 1j * rng.normal(size=(2, 2, 2, NZA, NAZ))
    az = (np.linspace(0, 2 * np.pi, NAZ, endpoint=False) if wrap
          else np.linspace(0, np.pi, NAZ))
    za = np.linspace(0, np.pi / 2, NZA)
    args = (data, az, za, [1.0e8, 1.2e8], "efield")
    return (GriddedBeam(*args, feeds=["x", "y"]),
            jax_gridded.GriddedBeam(*args, feeds=["x", "y"]))


def _points(n: int, dtype, order: int, wrap: bool, seed: int):
    """(az, za, mask) with seam, last-row and below-horizon points."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(0, 2 * np.pi, n)
    za = rng.uniform(0, np.pi / 2, n)
    mask = (rng.uniform(size=n) > 0.25).astype(float)
    seam = [0.0, 1e-9, 2 * np.pi - 1e-6, 2 * np.pi, np.pi]
    az[: len(seam)], mask[: len(seam)] = seam, 1.0
    k = len(seam)
    za[k : k + 4], mask[k : k + 4] = np.pi / 2, 1.0  # on the last za row
    za[k + 4 : k + 6], mask[k + 4 : k + 6] = np.pi / 2 - 1e-6, 1.0
    za[k + 6 : k + 10], mask[k + 6 : k + 10] = np.pi / 2, 0.0  # below the horizon
    az, za = az.astype(dtype), za.astype(dtype)
    if dtype == np.float64 and order == 1:
        mask[za >= np.pi / 2] = 0.0
        if not wrap:
            mask[az >= np.pi] = 0.0
    return az, za, mask.astype(dtype)


def _sky(n: int, epilogue: str, seed: int):
    """The sky at both frequencies: (n, 2) Stokes I or (n, 2, 2, 2) IQUV."""
    rng = np.random.default_rng(seed)
    flux = rng.uniform(0.1, 1.0, (n, 2))
    if not epilogue.startswith("jones-iquv"):
        return flux
    iquv = np.stack([flux, *rng.uniform(-0.05, 0.05, (3, n, 2))], axis=-1)
    return coherency.build_coherency(iquv, True)


def _prepared(epilogue: str, order: int, wrap: bool, dtype):
    beam, jbeam = _beams(wrap, real=epilogue.endswith("-real"))
    polarized = epilogue != "power"
    if not polarized:
        beam = prepare_beam_unpolarized(beam, use_feed="y")
        jbeam = jax_interface.prepare_beam_unpolarized(jbeam, use_feed="y")
    opts = {"order": order}
    pb = prepare_beam(beam, FREQS, polarized, spline_opts=opts, dtype=dtype, device="cpu")
    jpb = jax_interface.prepare_beam(jbeam, FREQS, polarized, spline_opts=opts)
    return pb, jpb, polarized


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("epilogue", EPILOGUES + REAL_TABLE)
def test_beam_rows_match_reference(epilogue, order, wrap, dtype):
    npdt = np.float64 if dtype == torch.float64 else np.float32
    pb, jpb, polarized = _prepared(epilogue, order, wrap, dtype)
    assert pb.grid.is_complex == (polarized and not epilogue.endswith("-real"))
    iquv = epilogue.startswith("jones-iquv")
    n = 300
    az, za, mask = _points(n, npdt, order, wrap, seed=order + 2 * wrap)
    sky = _sky(n, epilogue, seed=7)
    cdt = CDT[dtype]
    sky_t = torch.from_numpy(sky.astype(cdt if iquv else npdt))
    t = torch.from_numpy
    for fi, fv in enumerate(FREQS):
        flux = sky_t[:, fi]  # a strided view, as the engine passes it
        got = pb.rows(t(az), t(za), fv, fi, flux, t(mask), iquv, eval_mod.COMPLEX[dtype])
        plain = eval_mod.beam_rows_plain(pb.table[fi], t(az), t(za), flux, t(mask),
                                         pb.grid, iquv)
        assert torch.equal(got, plain)
        e = jpb.evaluate(jnp.asarray(az), jnp.asarray(za), fv, fi)
        want = jax_coh.apparent_coherency_rows(e, e, jnp.asarray(sky[:, fi]), polarized, iquv)
        want = np.asarray(want).astype(cdt) * mask[None, :]
        got = got.numpy()
        assert got.shape == want.shape == ((4, n) if polarized else (1, n))
        assert got.dtype == cdt
        np.testing.assert_allclose(got, want, atol=TOL[dtype] * np.abs(want).max(), rtol=0)
        assert np.all(got[:, mask == 0] == 0)


@pytest.mark.parametrize("polarized", [True, False])
def test_analytic_rows_are_evaluate_then_coherency(polarized):
    """An analytic beam has no table: rows is evaluate + coherency x mask."""
    az, za, mask = (torch.from_numpy(a) for a in _points(50, np.float64, 3, True, seed=1))
    flux = torch.from_numpy(_sky(50, "jones-I", seed=2)[:, 0])
    pb = prepare_beam(ShortDipoleBeam(), [1e8], polarized, device="cpu")
    assert pb.table is None
    got = pb.rows(az, za, 1e8, 0, flux, mask, False, torch.complex128)
    e = pb.evaluate(az, za, 1e8, 0)
    want = coherency.apparent_coherency_rows(e, e, flux, polarized, False) * mask[None, :]
    assert torch.equal(got, want)


def _sim_inputs(precision: int, polarized: bool, iquv: bool, order: int):
    ants = hex_array(3)
    ra, dec = healpix_radec(8)
    rng = np.random.default_rng(0)
    flux = rng.uniform(0.1, 1.0, (ra.size, 2))
    if iquv:
        flux = np.stack([flux, *(rng.uniform(-0.05, 0.05, (3, ra.size, 2)))], axis=-1)
    return dict(
        ants=ants, ra=ra, dec=dec, fluxes=flux, freqs=np.array([1.0e8, 1.1e8]),
        times=2459863.2 + np.linspace(0, 0.01, 2),
        baselines=[red[0] for red in get_pos_reds(ants, include_autos=True)],
        precision=precision, polarized=polarized, beam_spline_opts={"order": order},
        telescope_loc=TelescopeLocation(*SITE),
    )


@pytest.mark.parametrize("precision,polarized,iquv,order", [
    (2, True, False, 3), (1, True, False, 3), (2, True, True, 3), (2, False, False, 1),
])
def test_run_program_through_fused_rows(monkeypatch, precision, polarized, iquv, order):
    """The type-3 loop on the CPU: PreparedBeam.rows (beam_rows_plain, one
    call a source block) against the same beam without its table, whose
    rows are evaluate + apparent_coherency_rows."""
    kw = _sim_inputs(precision, polarized, iquv, order)
    beam = BeamInterface(read_beamfits(ASSET))
    if not polarized:
        beam = prepare_beam_unpolarized(beam)
    engine = CUDASimulationEngine(nufft_mode="type3", device="cpu")
    calls = []
    plain = eval_mod.beam_rows_plain
    monkeypatch.setattr(eval_mod, "beam_rows_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    fused = engine.simulate(beam_list=[beam], **kw)
    assert len(calls) == 4  # 2 times x 2 frequencies x 1 source block

    prepare = engine_mod.prepare_beams

    def unfused(*a, **k):
        return [PreparedBeam(pb.evaluate, pb.polarized) for pb in prepare(*a, **k)]

    monkeypatch.setattr(engine_mod, "prepare_beams", unfused)
    want = engine.simulate(beam_list=[beam], **kw)
    assert len(calls) == 4
    assert fused.shape == want.shape and np.all(np.isfinite(fused))
    np.testing.assert_allclose(fused, want, atol=1e-12 * np.abs(want).max(), rtol=0)


def test_entry_points_default_to_cuda():
    for fn in (Type3Executor.__init__, prepare_beam, CUDASimulationEngine.__init__,
               simulate_vis):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def _rows_args(case: str):
    """beam_rows arguments on the CPU, broken as ``case`` says."""
    pb, _, _ = _prepared("jones-I", 3, True, torch.float64)
    n = 16
    az, za, mask = (torch.from_numpy(a) for a in _points(n, np.float64, 3, True, seed=3))
    sky = torch.ones(n, dtype=torch.float64)
    table, grid, iquv = pb.table[0], pb.grid, False
    if case == "dtype":
        az = az.float()
    elif case == "points":
        za = za[:-1]
    elif case == "sky":
        iquv = True
    elif case == "mask":
        mask = mask[:, None]
    elif case == "table":
        table = table[:, ::2]
    elif case == "channels":
        table = table[..., :4].contiguous()
    elif case == "order":
        grid = dataclasses.replace(grid, order=2)
    return table, az, za, sky, mask, grid, iquv


@pytest.mark.parametrize("case", ["dtype", "points", "sky", "mask", "table", "channels",
                                  "order"])
def test_beam_rows_wrapper_refuses(case):
    with pytest.raises((TypeError, ValueError)):
        eval_mod.beam_rows(*_rows_args(case))


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 471])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("epilogue", EPILOGUES + REAL_TABLE)
def test_cuda_beam_rows_match_plain(cuda_device, epilogue, order, wrap, dtype, n):
    npdt = np.float64 if dtype == torch.float64 else np.float32
    pb, _, _ = _prepared(epilogue, order, wrap, dtype)
    iquv = epilogue.startswith("jones-iquv")
    az, za, mask = (torch.tensor(a, device=cuda_device)
                    for a in _points(n, npdt, order, wrap, seed=5))
    sky = _sky(n, epilogue, seed=6)
    sky = torch.tensor(sky.astype(CDT[dtype] if iquv else npdt), device=cuda_device)
    table = pb.table.to(cuda_device)
    before = eval_mod.rows_launches
    got = eval_mod.beam_rows(table[1], az, za, sky[:, 1], mask, pb.grid, iquv)
    assert eval_mod.rows_launches == before + 1
    want = eval_mod.beam_rows_plain(table[1], az, za, sky[:, 1], mask, pb.grid, iquv)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (got - want).abs().max().item() <= TOL[dtype] * want.abs().max().item()
    assert torch.all(got[:, mask == 0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("ch", [2, 20, 296])
@pytest.mark.parametrize("wrap", [True, False])
def test_cuda_beam_eval_matches_plain(cuda_device, wrap, ch):
    """The interpolation-only kernel on whole and ragged chunks of 8
    channels, clamped and wrapped, order 3."""
    ny, nx, n = 91, 360, 1000
    rng = np.random.default_rng(ch)
    data = spline_prefilter_2d(rng.normal(size=(ny, nx, ch)), axes=(0, 1), periodic_x=wrap)
    data = torch.tensor(data, dtype=torch.float32, device=cuda_device)
    y = torch.tensor(rng.uniform(-0.5, ny - 0.5, n), dtype=torch.float32, device=cuda_device)
    x = torch.tensor(rng.uniform(-1.0, nx + 1.0, n), dtype=torch.float32, device=cuda_device)
    got = eval_mod.beam_eval(data, y, x, order=3, wrap_x=wrap)
    want = eval_mod.beam_eval_plain(data, y, x, order=3, wrap_x=wrap)
    assert (got - want).abs().max().item() <= TOL[torch.float32] * want.abs().max().item()
