"""Non-coplanar (3D) arrays: the port's planner and ``simulate_vis`` path on
the CPU against ``fftvis_tpu`` and the float64 direct oracle.

The array is hex_array(3) with about +-2 m of z scatter (seed 23), 190 i <=
j baselines, 240 sources, 2 frequencies x 2 times (1 x 1 with per-antenna
beams or a basis, whose 4 P K grid channels the CPU's plain spread pays):

- the planner takes the JAX planner's path (the low-rank-z type-3 or the
  direct path) with its K, 2D fine grid and width, on this array and at the
  JAX bench's ``noncoplanar_3d`` size (hex_array(8), 14,365 baselines: K =
  17 low-rank-z at precision 1, direct at precision 2 unless type-3 is
  forced, K = 24); a tall array (+-20 m) falls back to the direct path at
  precision 2 as in JAX; a tilted array plans the same z range as JAX;
- ``upper_hemisphere_z_range`` against a brute-force sampling of the
  hemisphere for rotation rows pointing up and down (the plane rotation
  always points its z row up, so the down branch is reached only here);
- the engine in ``auto`` mode at precision 1 and 2 (the direct path at
  this size, as in JAX), with type-3 forced and with the direct path,
  unpolarized and polarized, with one shared beam,
  per-antenna beams (the padded and the per-pair routing) and an eigenbeam
  basis: 1e-4 / 1e-9 of max|V| against ``fftvis_tpu`` and 1e-4 / 1e-5
  against the direct oracle (precision 1 / 2).
"""

from pathlib import Path

import numpy as np
import pytest

from fftvis_tpu import TelescopeLocation as JaxLocation
from fftvis_tpu import compute_beam_basis as jax_compute_beam_basis
from fftvis_tpu.beams import GaussianBeam as JaxGaussian
from fftvis_tpu.beams import GriddedBeam as JaxGridded
from fftvis_tpu.beams import io as jax_io
from fftvis_tpu.beams import synth as jax_synth
from fftvis_tpu.reference.direct_engine import DirectSimulationEngine
from fftvis_tpu.tpu import planning as jax_planning
from fftvis_tpu.tpu.engine import TPUSimulationEngine
from fftvis_tpu.wrapper import prepare_beam_list as jax_prepare_beam_list
from fftvis_tpu_torch import CUDASimulationEngine, TelescopeLocation
from fftvis_tpu_torch.beams import GaussianBeam, GriddedBeam, perturbed_variants, read_beamfits
from fftvis_tpu_torch.core.beams import plan_beam_pairs
from fftvis_tpu_torch.cuda import planning
from fftvis_tpu_torch.cuda.engine import pair_routing
from fftvis_tpu_torch.geometry import hex_array
from fftvis_tpu_torch.nufft.transform import Type3LowrankZExecutor
from fftvis_tpu_torch.wrapper import prepare_beam_list

ASSET = str(Path(__file__).resolve().parent / "data" / "structured_dipole_100MHz.beamfits")
SITE = (np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
FREQS = np.array([1.0e8, 1.1e8])
EPS = {1: 5e-7, 2: 1e-13}  # the engine's eps at each precision (float32 floored)
VS_REFERENCE = {1: 1e-4, 2: 1e-9}
VS_ORACLE = {1: 1e-4, 2: 1e-5}


def _array(hex_n=3, z=2.0, seed=23):
    rng = np.random.default_rng(seed)
    return {k: np.array([p[0], p[1], rng.uniform(-z, z)])
            for k, p in hex_array(hex_n, sep=14.6).items()}


def _baselines(ants):
    keys = list(ants)
    return [(keys[i], keys[j]) for i in range(len(keys)) for j in range(i, len(keys))]


def _inputs(iquv=False, freqs=FREQS, ntimes=2):
    ants = _array()
    rng = np.random.default_rng(5)
    n = 240
    flux = rng.uniform(0.1, 1.0, (n, freqs.size))
    if iquv:
        flux = np.stack([flux, *(rng.uniform(-0.05, 0.05, (3, n, freqs.size)))], axis=-1)
    return dict(ants=ants, fluxes=flux, ra=rng.uniform(0, 2 * np.pi, n),
                dec=rng.uniform(np.deg2rad(-80.0), np.deg2rad(20.0), n), freqs=freqs,
                times=2459863.2 + np.linspace(0, 0.01, ntimes), baselines=_baselines(ants))


def _plan_both(mode, ants, eps, nsrc=240, npairs=1, nfeeds=1, beam_idx=None):
    bls = _baselines(ants)
    flipped = np.zeros(len(bls), dtype=bool)
    if beam_idx is not None:
        pp = plan_beam_pairs(list(ants), bls, beam_idx)
        for sel, fl in zip(pp.bls_idxs, pp.flipped):
            flipped[sel] = fl
        npairs = pp.npairs
    args = (ants, bls, FREQS, eps, 2.0, 1e-6, False, flipped, len(bls), nsrc, nfeeds, npairs)
    return planning.plan_transform(mode, *args, device="cpu"), jax_planning.plan_transform(
        mode, *args)


def _same_plan(got, want):
    assert got.mode == want.mode and got.is_coplanar == want.is_coplanar is False
    np.testing.assert_array_equal(got.rotation_matrix, want.rotation_matrix)
    np.testing.assert_array_equal(got.coord_matrix, want.rotation_matrix)
    if got.mode == "direct":
        np.testing.assert_array_equal(got.targets, want.targets)
        assert got.targets.shape[0] == 3
        return None
    assert isinstance(got.executor, Type3LowrankZExecutor)
    gz, wz = got.executor.zplan, want.executor.zplan
    assert (gz.K, gz.s_center_z, gz.x_center_z, gz.x_half_z) == (
        wz.K, wz.s_center_z, wz.x_center_z, wz.x_half_z)
    np.testing.assert_array_equal(gz.g, wz.g)
    assert (gz.plan2d.nf, gz.plan2d.kernel.w) == (wz.plan2d.nf, wz.plan2d.kernel.w)
    for a, b in zip(gz.plan2d.ft_coefs, wz.plan2d.ft_coefs):
        np.testing.assert_array_equal(a, b)
    assert got.executor.channel_multiplier == gz.K
    return gz


@pytest.mark.parametrize("case", ["auto p1", "auto p2", "type3 p2", "direct p2",
                                  "per-antenna type3 p2", "bench p1", "bench p2",
                                  "bench type3 p2", "tall p2", "tilted p1"])
def test_planner_matches_reference(case):
    """Path, K, fine grid and width as the JAX planner's; the bench row's
    K = 17 (precision 1, low-rank-z) and 24 (precision 2 forced)."""
    mode = case.split()[-2] if case.split()[0] != "per-antenna" else "type3"
    mode = {"bench": "auto", "tall": "auto", "tilted": "auto"}.get(mode, mode)
    p = int(case[-1])
    big = case.startswith(("bench", "tilted"))
    ants = _array(8) if big else _array(z=20.0 if case == "tall p2" else 2.0)
    nsrc = 25047 if big else 240
    if case == "tilted p1":
        # A plane tilted by 0.3 rad about x, with the scatter.
        c, s = np.cos(0.3), np.sin(0.3)
        ants = {k: np.array([v[0], c * v[1] - s * v[2], s * v[1] + c * v[2]])
                for k, v in ants.items()}
    beam_idx = np.arange(19) % 3 if case.startswith("per-antenna") else None
    got, want = _plan_both(mode, ants, EPS[p], nsrc=nsrc, beam_idx=beam_idx)
    zplan = _same_plan(got, want)
    expect = {"bench p1": ("type3", 17), "bench p2": ("direct", None),
              "bench type3 p2": ("type3", 24), "tall p2": ("direct", None),
              "auto p1": ("direct", None), "tilted p1": ("type3", None)}.get(case)
    if expect is not None:
        assert got.mode == expect[0]
        if expect[1] is not None:
            assert zplan.K == expect[1]
    if case == "tilted p1":
        # The plane rotation's z row is tilted: the range is not [0, 1].
        r = got.rotation_matrix[2]
        assert 0 < r[2] < 1
        zlo, zhi = planning.upper_hemisphere_z_range(r)
        assert (zlo, zhi) == (-float(np.hypot(r[0], r[1])), 1.0)


@pytest.mark.parametrize("r", [(0.0, 0.0, 1.0), (0.3, -0.2, 0.9), (0.5, 0.4, -0.6),
                               (0.0, 0.0, -1.0), (0.6, 0.8, 0.0)])
def test_upper_hemisphere_z_range_brute_force(r):
    r = np.asarray(r) / np.linalg.norm(r)
    zlo, zhi = planning.upper_hemisphere_z_range(r)
    rng = np.random.default_rng(0)
    v = rng.normal(size=(3, 200000))
    v /= np.linalg.norm(v, axis=0)
    v[2] = np.abs(v[2])
    ring = np.linspace(0, 2 * np.pi, 4001)
    v = np.concatenate([v, np.stack([np.cos(ring), np.sin(ring), 0 * ring]),
                        np.array([[0.0], [0.0], [1.0]])], axis=1)
    z = r @ v
    assert zlo <= z.min() + 1e-12 and z.max() <= zhi + 1e-12
    assert z.min() - zlo < 1e-3 and zhi - z.max() < 1e-3


# ------------------------------------------------------------ the engine

def _beams(kind, nant, freqs):
    """(port list, JAX list, beam_idx, beam_coefs) of a beam setup."""
    if kind == "shared":
        return [GaussianBeam(diameter=14.0)], [JaxGaussian(diameter=14.0)], None, None
    if kind in ("padded", "per-pair"):
        # 'padded': antenna a takes beam a % 3 (balanced pairs); 'per-pair':
        # antennas 0 and 1 one beam each and the rest beam 2 (skewed pairs).
        idx = np.arange(nant) % 3 if kind == "padded" else np.minimum(np.arange(nant), 2)
        return (perturbed_variants(read_beamfits(ASSET), 3),
                jax_synth.perturbed_variants(jax_io.read_beamfits(ASSET), 3), idx, None)
    jbeams = [JaxGridded.from_function(JaxGaussian(diameter=8.0 + 2.0 * i), n_az=91, n_za=46,
                                       freqs=tuple(freqs)) for i in range(2)]
    jeig, jcoefs = jax_compute_beam_basis(jbeams, freqs[0], True, threshold=1e-12)
    eig = [GriddedBeam(e.data_array, e.axis1_array, e.axis2_array, e.freq_array, e.beam_type)
           for e in jeig]
    coefs = np.repeat(jcoefs[np.arange(nant) % 2][:, :, None], freqs.size, axis=2)
    return eig, jeig, None, coefs


def _three_ways(mode, precision, kind, polarized, iquv=False):
    # Per-antenna and basis setups grid 4 P K channels: one time and one
    # frequency keep them short.
    kw = _inputs(iquv=iquv) if kind == "shared" else _inputs(iquv, FREQS[:1], ntimes=1)
    nant = len(kw["ants"])
    beams, jbeams, beam_idx, coefs = _beams(kind, nant, kw["freqs"])
    if beam_idx is not None:
        pp = plan_beam_pairs(list(kw["ants"]), kw["baselines"], beam_idx)
        assert pair_routing(pp, len(kw["baselines"]))[0] == (kind == "padded")
    args = (kw["freqs"], polarized, coefs, "x", nant, beam_idx)
    pbl, pidx = prepare_beam_list(beams, *args)
    jbl, jidx = jax_prepare_beam_list(jbeams, *args)
    kw.update(precision=precision, polarized=polarized, beam_coefs=coefs)
    got = CUDASimulationEngine(nufft_mode=mode, device="cpu").simulate(
        beam_list=pbl, beam_idx=pidx, telescope_loc=TelescopeLocation(*SITE), **kw)
    want = TPUSimulationEngine(nufft_mode=mode).simulate(
        beam_list=jbl, beam_idx=jidx, telescope_loc=JaxLocation(*SITE), **kw)
    oracle = DirectSimulationEngine().simulate(
        beam_list=jbl, beam_idx=jidx, telescope_loc=JaxLocation(*SITE), **kw)
    return got, want, oracle


@pytest.mark.parametrize("mode,precision,kind,polarized", [
    ("auto", 1, "shared", False), ("auto", 2, "shared", False),
    ("type3", 1, "shared", False), ("type3", 2, "shared", False),
    ("direct", 2, "shared", False),
    ("auto", 1, "shared", True), ("type3", 2, "shared", True),
    ("type3", 1, "padded", True), ("type3", 2, "padded", True), ("direct", 2, "padded", True),
    ("type3", 2, "per-pair", True), ("direct", 2, "per-pair", True),
    ("type3", 2, "basis", True), ("direct", 2, "basis", True),
])
def test_engine_matches_reference_and_oracle(mode, precision, kind, polarized, monkeypatch):
    # Per-antenna cases hold the pair routing itself on both sides.
    monkeypatch.setenv("FFTVIS_AUTO_RANK", "0")
    got, want, oracle = _three_ways(mode, precision, kind, polarized,
                                    iquv=kind == "padded" and precision == 2)
    scale = np.abs(oracle).max()
    assert got.shape == want.shape == oracle.shape
    assert got.dtype == want.dtype
    assert np.all(np.isfinite(got))
    assert np.abs(got - want).max() / scale <= VS_REFERENCE[precision]
    assert np.abs(got - oracle).max() / scale <= VS_ORACLE[precision]
