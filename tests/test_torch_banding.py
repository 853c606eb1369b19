"""Per-time horizon banding: the port's copy of the band planner and its
engine's banded loop on the CPU against ``fftvis_tpu``.

- ``plan_horizon_bands`` gives the JAX function's ``perm``, ``active_idx``
  and ``active_val`` (a 1-day observation), or None where it gives None (a
  30-minute window; an all-circumpolar sky), the cases of
  ``tests/test_banding.py``;
- banded equals ``FFTVIS_BAND=0`` within 1e-11 of max|V| at precision 2
  (10 times over a day, hex_array(3), a 4800-source isotropic sky with
  ``FFTVIS_BAND_BLOCK=128``: 34 blocks, at most 26 active at a time) on the
  exact type-1, type-3 (one frequency: the CPU's plain spread is what the
  file spends) and direct paths, for a Stokes-I sky, an IQUV sky,
  per-antenna beams and an eigenbeam basis; the type-1 path adds one
  product a frequency for each active block of each time, nothing more;
- the port's banded result equals the JAX package's banded result (1e-9);
- a banded call leaves the cached rotation's arrays as they were, and a
  second call takes the band plan from the cache;
- ``FFTVIS_BAND=0`` and ``FFTVIS_BAND_BLOCK`` reach the cache keys.
"""

import logging

import numpy as np
import pytest

from fftvis_tpu import TelescopeLocation as JaxLocation
from fftvis_tpu import simulate_vis as jax_simulate_vis
from fftvis_tpu.beams import GaussianBeam as JaxGaussian
from fftvis_tpu.coords import banding as jax_banding
from fftvis_tpu.coords.rotation import SourceRotation as JaxRotation
from fftvis_tpu_torch import TelescopeLocation, clear_caches, simulate_vis
from fftvis_tpu_torch.beams import GaussianBeam
from fftvis_tpu_torch.coords import banding
from fftvis_tpu_torch.coords.rotation import SourceRotation
from fftvis_tpu_torch.cuda import engine
from fftvis_tpu_torch.geometry import hex_array
from fftvis_tpu_torch.nufft import type1

SITE = (np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JD0 = 2459863.2
DAY = JD0 + np.linspace(0, 1.0, 10)
VS_UNBANDED = 1e-11
VS_REFERENCE = 1e-9
MODES = {"type1": "auto", "type3": "type3", "direct": "direct"}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("FFTVIS_BAND", raising=False)
    monkeypatch.setenv("FFTVIS_BAND_BLOCK", "128")
    clear_caches()
    yield
    clear_caches()


def _sky(n, seed=7):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 2 * np.pi, n), np.arcsin(rng.uniform(-1, 1, n)), rng


# ---------------------------------------------------------------- planner

@pytest.mark.parametrize("case", ["day", "short", "circumpolar"])
def test_plan_copy_matches_reference(case):
    if case == "circumpolar":
        rng = np.random.default_rng(0)
        ra, dec, times = rng.uniform(0, 2 * np.pi, 600), np.full(600, np.deg2rad(-85.0)), DAY
    else:
        ra, dec, _ = _sky(3000)
        times = JD0 + np.linspace(0, 1.0 if case == "day" else 30 / 60 / 24, 12)
    rot = SourceRotation(ra, dec, times, SITE)
    jrot = JaxRotation(ra, dec, times, SITE)
    rot.cull_never_visible()
    jrot.cull_never_visible()
    nb = 60 if case == "circumpolar" else 64
    blk = int(np.ceil(rot.nsrc / nb))
    for t in (0, rot.ntimes - 1):
        np.testing.assert_array_equal(rot.topo_at(t), jrot.topo_at(t))
    got = banding.plan_horizon_bands(rot, blk, nb, blk * nb)
    want = jax_banding.plan_horizon_bands(jrot, blk, nb, blk * nb)
    assert (got is None) == (want is None) == (case != "day")
    if got is not None:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- engine

def _kw(sky="stokes-I", nsrc=4800, freqs=(1e8, 1.1e8)):
    ra, dec, rng = _sky(nsrc)
    nf = len(freqs)
    flux = rng.uniform(0.1, 1.0, (nsrc, nf))
    if sky == "iquv":
        flux = np.stack([flux, *(0.1 * rng.uniform(-1, 1, (3, nsrc, nf)))], axis=-1)
    kw = dict(ants=hex_array(3, sep=14.6), fluxes=flux, ra=ra, dec=dec,
              freqs=np.array(freqs), times=DAY, beam=GaussianBeam(diameter=14.0),
              telescope_loc=TelescopeLocation(*SITE), polarized=sky != "stokes-I",
              precision=2, device="cpu")
    if sky == "per-antenna":
        kw["beam"] = [GaussianBeam(diameter=12.0), GaussianBeam(diameter=14.0)]
        kw["beam_idx"] = np.arange(len(kw["ants"])) % 2
    elif sky == "basis":
        kw["beam"] = [GaussianBeam(diameter=12.0), GaussianBeam(diameter=14.0)]
        rng = np.random.default_rng(4)
        shape = (len(kw["ants"]), 2, nf)
        kw["beam_coefs"] = rng.uniform(0.5, 1.5, shape) + 0.1j * rng.uniform(-1, 1, shape)
    return kw


def _run(path, kw):
    """The engine on one path, through simulate_vis's beam preparation."""
    from fftvis_tpu_torch import CUDASimulationEngine
    from fftvis_tpu_torch.wrapper import prepare_beam_list

    beams, beam_idx = prepare_beam_list(kw["beam"], kw["freqs"], kw["polarized"],
                                        kw.get("beam_coefs"), "x", len(kw["ants"]),
                                        kw.get("beam_idx"))
    ekw = {k: v for k, v in kw.items() if k not in ("beam", "beam_idx", "device")}
    return CUDASimulationEngine(nufft_mode=MODES[path], device="cpu").simulate(
        beam_list=beams, beam_idx=beam_idx, **ekw)


def _active(monkeypatch):
    """Record the band plans the engine makes."""
    plans = []
    real = engine.plan_horizon_bands

    def spy(rot, blk, nb, pad):
        out = real(rot, blk, nb, pad)
        plans.append((blk, nb, out))
        return out

    monkeypatch.setattr(engine, "plan_horizon_bands", spy)
    return plans


@pytest.mark.parametrize("path", list(MODES))
@pytest.mark.parametrize("sky", ["stokes-I", "iquv", "per-antenna", "basis"])
def test_banded_equals_unbanded(sky, path, monkeypatch, caplog):
    kw = _kw(sky, freqs=(1e8,) if path == "type3" else (1e8, 1.1e8))
    plans = _active(monkeypatch)
    caplog.set_level(logging.INFO, logger="fftvis_tpu_torch.cuda.engine")
    type1.products = 0
    v_band = _run(path, kw)
    banded_products = type1.products
    assert any("horizon banding engaged" in r.message for r in caplog.records)
    assert len(plans) == 1 and plans[0][2] is not None
    monkeypatch.setenv("FFTVIS_BAND", "0")
    type1.products = 0
    v_ref = _run(path, kw)
    assert len(plans) == 1
    scale = np.abs(v_ref).max()
    assert np.abs(v_band - v_ref).max() / scale < VS_UNBANDED
    if path == "type1":
        _, idx, val = plans[0][2]
        nblocks = -(-(kw["ra"].size - _culled(kw)) // engine.SOURCE_BLOCK)
        assert banded_products == 2 * int((val > 0).sum())
        assert type1.products == 2 * len(DAY) * nblocks


def _culled(kw):
    rot = SourceRotation(kw["ra"], kw["dec"], kw["times"], SITE)
    keep = rot.cull_never_visible()
    return 0 if keep is None else int((~keep).sum())


@pytest.mark.parametrize("path", ["type1", "type3"])
def test_banded_matches_reference(path, monkeypatch):
    """The port's banded run against the JAX package's banded run."""
    kw = _kw()
    got = simulate_vis(**kw, force_use_type3=path == "type3")
    jkw = dict(kw, beam=JaxGaussian(diameter=14.0), telescope_loc=JaxLocation(*SITE))
    del jkw["device"]
    want = jax_simulate_vis(**jkw, force_use_type3=path == "type3")
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < VS_REFERENCE


def _cached_rotation():
    rots = [v[0] for v in engine.PLAN_CACHE.entries.values()
            if isinstance(v, tuple) and isinstance(v[0], SourceRotation)]
    assert len(rots) == 1
    return rots[0]


def test_cached_rotation_unchanged_and_band_entry_hit(monkeypatch):
    kw = _kw()
    plans = _active(monkeypatch)
    first = simulate_vis(**kw)
    rot = _cached_rotation()
    eq = rot.eq_vectors
    fresh = SourceRotation(kw["ra"], kw["dec"], kw["times"], SITE)
    fresh.cull_never_visible()
    np.testing.assert_array_equal(eq, fresh.eq_vectors)
    assert not eq.flags.writeable
    second = simulate_vis(**kw)
    assert len(plans) == 1  # the band plan came from the cache
    assert _cached_rotation() is rot and rot.eq_vectors is eq
    np.testing.assert_array_equal(rot.eq_vectors, fresh.eq_vectors)
    np.testing.assert_array_equal(first, second)


def test_band_knobs_reach_the_cache_keys(monkeypatch):
    kw = _kw()
    plans = _active(monkeypatch)
    banded = simulate_vis(**kw)
    monkeypatch.setenv("FFTVIS_BAND_BLOCK", "512")
    other = simulate_vis(**kw)
    # 512-source blocks: 8 of them (the floor), not 34, planned afresh.
    assert len(plans) == 2 and (plans[0][1], plans[1][1]) == (34, 8)
    monkeypatch.setenv("FFTVIS_BAND", "0")
    plain = simulate_vis(**kw)
    assert len(plans) == 2  # no band plan under FFTVIS_BAND=0
    scale = np.abs(plain).max()
    assert np.abs(banded - plain).max() / scale < VS_UNBANDED
    assert np.abs(other - plain).max() / scale < VS_UNBANDED
    # Back to the first blocking: every entry hits, nothing is planned again.
    monkeypatch.setenv("FFTVIS_BAND", "1")
    monkeypatch.setenv("FFTVIS_BAND_BLOCK", "128")
    np.testing.assert_array_equal(simulate_vis(**kw), banded)
    assert len(plans) == 2
