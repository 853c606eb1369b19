"""The port's host layer: content hashing, source chunking and the caches
that a sweep of ``simulate_vis`` calls shares, on the CPU.

- ``core/hashing.py`` and the chunk model of ``core/utils.py`` are copies:
  they give the JAX package's digests, keys and chunk counts on the same
  inputs;
- a repeated call hits the plan, program, input, prepared-beam and stack
  caches, and its result equals the cold call's and the JAX package's on
  the same seeded inputs (1e-9 of max|V| at precision=2, 1e-4 at
  precision=1; both sides with ``FFTVIS_AUTO_RANK=0``, which keeps a
  polarized per-antenna list on the pair routing);
- every input and knob that changes the result changes a key: after it
  changes, the warm caches give exactly the answer of cold caches (or raise
  as they do); auto-rank's knob, the ``beam_coefs`` values and its channel
  list's kind among them, and a warm auto-ranked call takes its plan and
  its stacked eigenbeam table from the caches;
- ``min_chunks`` and ``max_memory`` change the source blocks and not the
  answer: 1e-12 / 1e-5 of max|V| at precision 2 / 1, what another
  summation order gives in the dtype.

On a CUDA card (marked ``cuda``; skipped without one): warm calls equal the
cold one within the same 1e-12 / 1e-5 of max|V| (the type-3 spread
accumulates with atomics, so a result is not bitwise stable) and launch the
same kernels, and a configuration cached on the CPU runs on the card with
the card's kernels.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fftvis_tpu import TelescopeLocation as JaxLocation
from fftvis_tpu import simulate_vis as jax_simulate_vis
from fftvis_tpu.beams import GaussianBeam as JaxGaussian
from fftvis_tpu.beams import io as jax_io
from fftvis_tpu.beams import synth as jax_synth
from fftvis_tpu.beams.interface import BeamInterface as JaxBeamInterface
from fftvis_tpu.beams.interface import prepare_beam_unpolarized as jax_unpolarized
from fftvis_tpu.core import hashing as jax_hashing
from fftvis_tpu.core import utils as jax_utils
from fftvis_tpu_torch import (
    CUDASimulationEngine,
    TelescopeLocation,
    compute_beam_basis,
    simulate_vis,
)
from fftvis_tpu_torch.beams import GaussianBeam, GriddedBeam, perturbed_variants, read_beamfits
from fftvis_tpu_torch.beams import interface
from fftvis_tpu_torch.beams.interface import (
    BeamInterface,
    prepare_beam,
    prepare_beam_unpolarized,
    prepare_beams,
    stack_prepared,
)
from fftvis_tpu_torch.core import hashing
from fftvis_tpu_torch.core import utils as core_utils
from fftvis_tpu_torch.cuda import engine as engine_mod
from fftvis_tpu_torch.cuda import program as program_mod
from fftvis_tpu_torch.cuda.planning import SimPlan
from fftvis_tpu_torch.geometry import hex_array
from fftvis_tpu_torch.utils import healpix_radec

ASSET = str(Path(__file__).resolve().parent / "data" / "structured_dipole_100MHz.beamfits")
SITE = (np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JD0 = 2459863.2
VS_REFERENCE = {2: 1e-9, 1: 1e-4}
# Two summation orders of one result (other source blocks; atomics on the
# card), relative to max|V|.
ORDER_TOL = {2: 1e-12, 1: 1e-5}


@pytest.fixture(autouse=True)
def _cold(monkeypatch):
    """Every test starts from empty caches; both sides keep the pair
    routing unless a test turns auto-rank on."""
    monkeypatch.setenv("FFTVIS_AUTO_RANK", "0")
    engine_mod.clear_caches()
    yield
    engine_mod.clear_caches()


def _hits():
    return {k: v[0] for k, v in engine_mod.cache_stats().items()}


def _misses():
    return {k: v[1] for k, v in engine_mod.cache_stats().items()}


# ------------------------------------------------------------- copies

def _hash_inputs():
    rng = np.random.default_rng(0)
    big = rng.normal(size=(300, 300))
    frozen = rng.normal(size=(50, 7))
    frozen.setflags(write=False)
    return [
        ("scalars", (1, 2.5, "x", None, True, b"ab")),
        ("small array", rng.normal(size=(4, 3))),
        ("big array", big),
        ("strided view", big[::2, 1::3]),
        ("frozen", frozen),
        ("int32", np.arange(1000, dtype=np.int32)),
        ("odd float32", np.arange(100_001, dtype=np.float32)),
        ("nested", ({"b": big, "a": [1, (2, 3)]}, ("reds-v1", ("0", "1")))),
    ]


@pytest.mark.parametrize("name,parts", _hash_inputs(), ids=[n for n, _ in _hash_inputs()])
def test_hash_parts_copy_identical(name, parts):
    assert hashing.hash_parts(parts) == jax_hashing.hash_parts(parts)
    # A second digest comes from the memo, and agrees too.
    assert hashing.hash_parts(parts) == jax_hashing.hash_parts(parts)


def _beam_pairs():
    """(port beam, fftvis_tpu beam) pairs of each kind a fingerprint takes."""
    tab, jtab = read_beamfits(ASSET), jax_io.read_beamfits(ASSET)
    return [
        ("gridded", tab, jtab),
        ("iface", BeamInterface(tab), JaxBeamInterface(jtab)),
        ("power", prepare_beam_unpolarized(tab, "y"), jax_unpolarized(jtab, "y")),
        ("analytic", GaussianBeam(diameter=12.0), JaxGaussian(diameter=12.0)),
        ("analytic power", prepare_beam_unpolarized(GaussianBeam(diameter=9.0)),
         jax_unpolarized(JaxGaussian(diameter=9.0))),
    ]


@pytest.mark.parametrize("kind", ["gridded", "iface", "power", "analytic", "analytic power"])
def test_beam_fingerprint_keys_identical(kind):
    _, beam, jbeam = next(p for p in _beam_pairs() if p[0] == kind)
    got = hashing.hash_parts(hashing.beam_fingerprint(beam))
    assert got == jax_hashing.hash_parts(jax_hashing.beam_fingerprint(jbeam))


@pytest.mark.parametrize("args", [
    (8e9, 1, 4, 2, 2, 19, 768, 2), (5e7, 1, 2, 1, 1, 331, 49152, 1),
    (2e6, 3, 2, 2, 2, 60, 10_000, 2), (1.0, 1, 1, 1, 1, 5, 40, 1),
], ids=["roomy", "north-star-like", "tight", "below-any"])
def test_chunk_model_copy_identical(args):
    freemem, min_chunks, nbeam, nax, nfeed, nant, nsrc, precision = args
    beams = [read_beamfits(ASSET)] * nbeam
    jbeams = [jax_io.read_beamfits(ASSET)] * nbeam
    got = core_utils.get_desired_chunks(freemem, min_chunks, beams, nax, nfeed, nant, nsrc,
                                        precision, source_buffer=0.8)
    assert got == jax_utils.get_desired_chunks(freemem, min_chunks, jbeams, nax, nfeed, nant,
                                               nsrc, precision, source_buffer=0.8)


class TestDigestMemo:
    """hash_parts tracks content with the identity memo active (the JAX
    package's ``TestDigestMemo``)."""

    def _big(self, seed=0):
        return np.random.default_rng(seed).normal(size=(300, 300))

    def test_repeat_hash_is_stable(self):
        a = self._big()
        assert hashing.hash_parts(a) == hashing.hash_parts(a)

    def test_inplace_mutation_changes_key(self):
        a = self._big()
        k0 = hashing.hash_parts(a)
        orig = float(a[17, 23])
        a[17, 23] = orig + 1.0
        assert hashing.hash_parts(a) != k0
        a[17, 23] = orig  # an exact restore
        assert hashing.hash_parts(a) == k0

    def test_dead_id_reuse_is_safe(self):
        keys = set()
        for seed in range(6):
            keys.add(hashing.hash_parts(self._big(seed)))
        assert len(keys) == 6

    def test_unfrozen_array_is_hashed_afresh(self):
        """An array memoized as frozen and made writeable again is hashed
        anew: its content may have changed (the JAX copy keeps the frozen
        digest)."""
        a = self._big()
        a.setflags(write=False)
        k0 = hashing.hash_parts(a)
        a.setflags(write=True)
        a[0, 0] += 1.0
        assert hashing.hash_parts(a) != k0

    def test_window_revalidates_once(self):
        a = self._big()
        k0 = hashing.hash_parts(a)
        with hashing.consistent_inputs():
            assert hashing.hash_parts(a) == k0
            assert hashing.hash_parts(a) == k0
        a[1, 1] += 1.0
        with hashing.consistent_inputs():
            assert hashing.hash_parts(a) != k0


def test_lru_cache_evicts_least_recent_and_counts():
    c = hashing.LRUCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1  # "a" is now the most recent
    c.put("c", 3)
    assert c.get("b") is None and c.get("a") == 1 and c.get("c") == 3
    assert (c.hits, c.misses) == (3, 1)
    assert c.get_or_build("d", lambda: 4) == 4 and len(c.entries) == 2
    c.clear()
    assert (c.hits, c.misses, len(c.entries)) == (0, 0, 0)


# ------------------------------------------------------------- beam caches

def test_large_beam_list_hits_cache_on_second_call(monkeypatch):
    """The prepared-beam LRU grows to hold a whole per-antenna list (the
    JAX package's ``TestBeamCacheWorkingSet``)."""
    nbeams = interface.PREPARED_CACHE.limit + 5
    beams = [GriddedBeam.from_function(GaussianBeam(diameter=12.0 + 0.01 * i),
                                       n_az=31, n_za=16, freqs=(1.0e8,))
             for i in range(nbeams)]
    misses = []
    orig = interface._prepare_beam_uncached
    monkeypatch.setattr(interface, "_prepare_beam_uncached",
                        lambda *a, **k: misses.append(1) or orig(*a, **k))
    kw = dict(freqs=np.array([1.0e8]), polarized=True, device="cpu")
    first = prepare_beams(beams, **kw)
    assert len(misses) == nbeams
    again = prepare_beams(beams, **kw)
    assert len(misses) == nbeams
    assert all(a is b for a, b in zip(first, again))


@pytest.mark.parametrize("change", ["dtype", "freqs", "spline", "feed", "polarized"])
def test_prepared_and_stacked_tables_follow_their_key(change):
    beams = perturbed_variants(read_beamfits(ASSET), 3)
    kw = dict(freqs=np.array([1.0e8]), polarized=True, spline_opts={"order": 1},
              use_feed="x", dtype=torch.float64, device="cpu")
    prepared = prepare_beams(beams, **kw)
    stacked = stack_prepared(prepared)
    assert stack_prepared(prepare_beams(beams, **kw)) is stacked
    assert all(not pb.host_table.flags.writeable for pb in prepared)
    other = dict(kw, **{"dtype": {"dtype": torch.float32}, "freqs": {"freqs": np.array([1.05e8])},
                        "spline": {"spline_opts": {"order": 3}},
                        "feed": {"use_feed": "y", "polarized": False},
                        "polarized": {"polarized": False}}[change])
    got = prepare_beams(beams, **other)
    engine_mod.clear_caches()
    want = prepare_beams(beams, **other)
    for g, w in zip(got, want):
        assert g.grid == w.grid and g.dtype == w.dtype
        assert np.array_equal(g.host_table, w.host_table)
    assert stack_prepared(got) is not stacked
    assert torch.equal(stack_prepared(got).table, stack_prepared(want).table)


# ------------------------------------------------------------- end to end

def _per_antenna(polarized=True, nbeams=3):
    """hex_array(3) (a lattice: the exact type-1 path in auto mode) with its
    redundant baselines, the nside=8 sky, 1 frequency x 2 times and
    ``nbeams`` complex variants of the committed beam, for both packages."""
    ants = hex_array(3)
    ra, dec = healpix_radec(8)
    rng = np.random.default_rng(0)
    kw = dict(ants=ants, ra=ra, dec=dec, fluxes=rng.uniform(0.1, 1.0, (ra.size, 1)),
              freqs=np.array([1.0e8]), times=JD0 + np.linspace(0, 0.01, 2),
              beam_idx=np.arange(len(ants)) % nbeams, polarized=polarized)
    beams = perturbed_variants(read_beamfits(ASSET), nbeams)
    jbeams = jax_synth.perturbed_variants(jax_io.read_beamfits(ASSET), nbeams)
    return kw, beams, jbeams


@pytest.mark.parametrize("precision", [2, 1])
def test_repeated_call_hits_every_cache(precision):
    kw, beams, jbeams = _per_antenna()
    cold = simulate_vis(beam=beams, telescope_loc=TelescopeLocation(*SITE), device="cpu",
                        precision=precision, **kw)
    first_misses = _misses()
    assert all(first_misses[k] > 0 for k in ("plan", "program", "input", "prepared", "stack"))
    hits0 = _hits()
    warm = simulate_vis(beam=beams, telescope_loc=TelescopeLocation(*SITE), device="cpu",
                        precision=precision, **kw)
    assert _misses() == first_misses  # nothing planned, prepared or uploaded again
    hits = _hits()
    assert all(hits[k] > hits0[k] for k in ("plan", "program", "input", "prepared", "stack"))
    np.testing.assert_array_equal(warm, cold)
    want = jax_simulate_vis(beam=jbeams, telescope_loc=JaxLocation(*SITE), precision=precision,
                            **kw)
    assert warm.shape == want.shape and warm.dtype == want.dtype
    assert np.abs(warm - want).max() / np.abs(want).max() <= VS_REFERENCE[precision]


def test_cached_objects_are_frozen_and_copied():
    kw, beams, _ = _per_antenna()
    simulate_vis(beam=beams, telescope_loc=TelescopeLocation(*SITE), device="cpu", **kw)
    rots = [v for v in engine_mod.PLAN_CACHE.entries.values()
            if isinstance(v, tuple) and len(v) == 2 and hasattr(v[0], "eq_vectors")]
    assert len(rots) == 1
    rot, keep = rots[0]
    for arr in (rot.eq_vectors, rot.matrices, rot.aberration, keep):
        assert not arr.flags.writeable
    plans = [v for v in engine_mod.PLAN_CACHE.entries.values() if isinstance(v, SimPlan)]
    assert len(plans) == 1
    with pytest.raises(AttributeError):
        plans[0].mode = "direct"


def _knob_inputs(knob):
    """(engine, kwargs) of the configuration a knob's case starts from."""
    rng = np.random.default_rng(11)
    ants = {i: np.array([*rng.uniform(-40, 40, 2), 0.0]) for i in range(5)}
    nsrc = 40
    kw = dict(ants=ants, fluxes=rng.uniform(0.1, 1.0, (nsrc, 2)),
              ra=rng.uniform(0, 2 * np.pi, nsrc),
              dec=np.clip(SITE[0] + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2),
              freqs=np.array([1.0e8, 1.1e8]), times=JD0 + np.linspace(0, 0.01, 2),
              telescope_loc=TelescopeLocation(*SITE), precision=2)
    mode = "type3"
    if knob in ("FFTVIS_TYPE1", "beam_idx", "FFTVIS_AUTO_RANK", "kl_sym"):
        ants = hex_array(2)
        kw.update(ants=ants, polarized=True, fluxes=kw["fluxes"][:, :1],
                  freqs=kw["freqs"][:1])
        mode = "auto"
    if knob in ("FFTVIS_AUTO_RANK", "kl_sym"):
        # 7 beams of a near-low-rank family on all 28 baselines i <= j, so
        # 28 pairs: auto-rank engages.
        kw.update(beam=_gaussian_tables(7), beam_idx=np.arange(7), eps=1e-6,
                  baselines=[(i, j) for i in range(7) for j in range(i, 7)])
    elif knob == "beam_coefs":
        eig, coefs = compute_beam_basis(_gaussian_tables(3), 1.0e8, True)
        kw.update(beam=eig, beam_coefs=coefs[np.arange(5) % 3][:, :, None].copy(),
                  polarized=True, fluxes=kw["fluxes"][:, :1], freqs=kw["freqs"][:1])
    elif knob in ("data_array", "uvbeam", "beam_idx", "FFTVIS_TYPE1", "polarized"):
        kw["beam"] = perturbed_variants(read_beamfits(ASSET), 2)
        kw["beam_idx"] = np.arange(len(kw["ants"])) % 2
        kw["fluxes"], kw["freqs"] = kw["fluxes"][:, :1], kw["freqs"][:1]
        kw.setdefault("polarized", True)
    elif knob in ("FFTVIS_ALLOW_BEAM_CLAMP", "FFTVIS_BEAM_UPSAMPLE"):
        full = read_beamfits(ASSET)
        short = GriddedBeam(full.data_array[..., :80, :], full.axis1_array,
                            full.axis2_array[:80], full.freq_array, full.beam_type,
                            feeds=full.feeds)
        kw.update(beam=short if knob == "FFTVIS_ALLOW_BEAM_CLAMP" else full,
                  polarized=True, beam_spline_opts={"order": 3},
                  fluxes=kw["fluxes"][:, :1], freqs=kw["freqs"][:1])
    else:
        kw["beam"] = GaussianBeam(diameter=12.0)
    if knob == "uvbeam":
        b = kw["beam"][0]
        kw["beam"] = [SimpleNamespace(
            data_array=np.array(b.data_array), axis1_array=b.axis1_array,
            axis2_array=b.axis2_array, freq_array=b.freq_array, beam_type=b.beam_type,
            feed_array=np.array(b.feeds)), kw["beam"][1]]
    return CUDASimulationEngine(nufft_mode=mode, device="cpu"), kw


def _gaussian_tables(n):
    """GaussianBeam(14 + 0.02 i) tabulated on one (16, 31) grid."""
    return [GriddedBeam.from_function(GaussianBeam(diameter=14.0 + 0.02 * i), n_az=31,
                                      n_za=16, freqs=(1.0e8,)) for i in range(n)]


def _change(knob, kw, monkeypatch):
    if knob == "fluxes":
        kw["fluxes"][:5] *= 1.5  # in place
    elif knob == "ra":
        kw["ra"][:3] += 0.05  # in place
    elif knob == "times":
        kw["times"][1] += 0.002  # in place
    elif knob == "freqs":
        kw["freqs"][:] = kw["freqs"] * 1.02  # in place
    elif knob == "ants":
        kw["ants"][2][0] += 0.7  # in place
    elif knob == "baselines":
        kw["baselines"] = [(0, 1), (1, 2), (0, 3), (2, 4), (3, 4)]
    elif knob == "beam_idx":
        kw["beam_idx"] = (kw["beam_idx"] + 1) % 2
    elif knob == "data_array":
        arr = kw["beam"][0].data_array
        arr.setflags(write=True)
        arr[:, :, :, 5:20] *= 1.3  # in place
    elif knob == "uvbeam":
        kw["beam"][0].data_array[:, :, :, 5:20] *= 1.3  # in place
    elif knob == "eps":
        kw["eps"] = 1e-6
    elif knob == "precision":
        kw["precision"] = 1
    elif knob == "polarized":
        kw["polarized"] = False
    elif knob == "aberration":
        kw["coord_method_params"] = {"include_aberration": False}
    elif knob == "FFTVIS_TYPE1":
        monkeypatch.setenv("FFTVIS_TYPE1", "es")
    elif knob == "FFTVIS_ALLOW_BEAM_CLAMP":
        monkeypatch.delenv("FFTVIS_ALLOW_BEAM_CLAMP")
    elif knob == "FFTVIS_BEAM_UPSAMPLE":
        monkeypatch.setenv("FFTVIS_BEAM_UPSAMPLE", "2")
    elif knob == "FFTVIS_AUTO_RANK":
        monkeypatch.setenv("FFTVIS_AUTO_RANK", "0")
    elif knob == "beam_coefs":
        kw["beam_coefs"][:, 0] *= 1.5  # in place
    elif knob == "kl_sym":
        # A polarized sky: auto-rank's ordered list in place of the
        # symmetric one.
        stokes = kw["fluxes"]
        pol = 0.05 * np.random.default_rng(12).uniform(-1, 1, (3,) + stokes.shape)
        kw["fluxes"] = np.stack([stokes, *pol], axis=-1)


def _outcome(engine, kw):
    from fftvis_tpu_torch.wrapper import prepare_beam_list

    beams, beam_idx = prepare_beam_list(kw["beam"], kw["freqs"], kw.get("polarized", False),
                                        kw.get("beam_coefs"), "x", len(kw["ants"]),
                                        kw.get("beam_idx"))
    ekw = {k: v for k, v in kw.items() if k not in ("beam", "beam_idx")}
    try:
        return engine.simulate(beam_list=beams, beam_idx=beam_idx, **ekw)
    except (NotImplementedError, ValueError) as exc:
        return type(exc)


KNOBS = ["fluxes", "ra", "times", "freqs", "ants", "baselines", "beam_idx", "data_array",
         "uvbeam", "eps", "precision", "polarized", "aberration", "FFTVIS_TYPE1",
         "FFTVIS_ALLOW_BEAM_CLAMP", "FFTVIS_BEAM_UPSAMPLE", "FFTVIS_AUTO_RANK", "beam_coefs",
         "kl_sym"]


@pytest.mark.parametrize("knob", KNOBS)
def test_cache_key_covers(knob, monkeypatch):
    """Prime every cache, change one input or knob (arrays in place), and
    the warm caches give the cold caches' answer, which differs from the
    first."""
    if knob == "FFTVIS_ALLOW_BEAM_CLAMP":
        monkeypatch.setenv("FFTVIS_ALLOW_BEAM_CLAMP", "1")
    if knob in ("FFTVIS_AUTO_RANK", "kl_sym"):
        monkeypatch.setenv("FFTVIS_AUTO_RANK", "1")
    engine, kw = _knob_inputs(knob)
    if knob == "baselines":
        kw["baselines"] = [(0, 1), (1, 2), (0, 3), (2, 4), (1, 4)]
    base = _outcome(engine, kw)
    assert isinstance(base, np.ndarray)
    _change(knob, kw, monkeypatch)
    got = _outcome(engine, kw)
    assert sum(engine_mod.cache_stats()[k][0] for k in ("plan", "prepared")) > 0
    engine_mod.clear_caches()
    want = _outcome(engine, kw)
    if isinstance(want, type):
        assert got is want  # both raise the same error
        return
    np.testing.assert_array_equal(got, want)
    assert got.shape != base.shape or not np.array_equal(got, base)


def test_warm_auto_rank_call_reuses_plan_and_stack(monkeypatch):
    """A repeated auto-ranked call takes its plan from the auto-rank cache
    (no second SVD) and its stacked eigenbeam table from the stack cache,
    and gives the cold call's answer."""
    monkeypatch.setenv("FFTVIS_AUTO_RANK", "1")
    engine, kw = _knob_inputs("FFTVIS_AUTO_RANK")
    cold = _outcome(engine, kw)
    first = engine_mod.cache_stats()
    assert first["autorank"] == (0, 1) and first["stack"][1] == 1
    stacks = dict(interface.STACK_CACHE.entries)
    (table,) = [s.table for s in stacks.values()]
    assert table.shape[-1] == 3 * 4  # K = 3 real Jones eigenbeams
    warm = _outcome(engine, kw)
    stats = engine_mod.cache_stats()
    assert stats["autorank"] == (1, 1)
    assert stats["stack"][1] == 1 and stats["stack"][0] > first["stack"][0]
    assert interface.STACK_CACHE.entries == stacks
    np.testing.assert_array_equal(warm, cold)


@pytest.mark.parametrize("limit", ["min_chunks", "max_memory"])
@pytest.mark.parametrize("precision", [2, 1])
def test_source_chunking_invariance(monkeypatch, limit, precision):
    """Source chunks from min_chunks, or from a max_memory below the memory
    model's least working set, change the blocks and not the result; the
    port agrees with the JAX package chunked the same way (the JAX
    package's ``test_source_chunking_invariance``)."""
    kw, beams, jbeams = _per_antenna()
    kw["precision"] = precision
    blocks = []
    orig = program_mod.BlockRows.__call__
    monkeypatch.setattr(program_mod.BlockRows, "__call__",
                        lambda self, *a: blocks.append(1) or orig(self, *a))
    site = TelescopeLocation(*SITE)
    one = simulate_vis(beam=beams, telescope_loc=site, device="cpu", **kw)
    n_one = len(blocks)
    chunk = {"min_chunks": 4} if limit == "min_chunks" else {"max_memory": 1e5}
    many = simulate_vis(beam=beams, telescope_loc=site, device="cpu", **chunk, **kw)
    assert len(blocks) - n_one > n_one  # more, smaller source blocks
    scale = np.abs(one).max()
    np.testing.assert_allclose(many, one, atol=ORDER_TOL[precision] * scale, rtol=0)
    want = jax_simulate_vis(beam=jbeams, telescope_loc=JaxLocation(*SITE), **chunk, **kw)
    assert np.abs(many - want).max() / np.abs(want).max() <= VS_REFERENCE[precision]


def test_available_memory_reads_the_device():
    from fftvis_tpu_torch.wrapper import available_memory

    assert 0 < available_memory("cpu") < float("inf")


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches():
    from fftvis_tpu_torch.beams import eval as eval_mod
    from fftvis_tpu_torch.nufft import interp as interp_mod
    from fftvis_tpu_torch.nufft import spread as spread_mod

    return (spread_mod.launches, interp_mod.launches, eval_mod.launches,
            eval_mod.rows_launches, eval_mod.pair_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [2, 1])
@pytest.mark.parametrize("config", ["per-antenna type-1", "tabulated type-3"])
def test_cuda_warm_calls_equal_cold(cuda_device, precision, config):
    if config == "per-antenna type-1":
        kw, beams, _ = _per_antenna()
        engine = CUDASimulationEngine(device=cuda_device)
    else:
        kw, beams, _ = _per_antenna(nbeams=1)
        beams = beams[0]
        kw.pop("beam_idx")
        engine = CUDASimulationEngine(nufft_mode="type3", device=cuda_device)
    from fftvis_tpu_torch.wrapper import prepare_beam_list

    blist, bidx = prepare_beam_list(beams, kw["freqs"], True, None, "x", len(kw["ants"]),
                                    kw.get("beam_idx"))
    ekw = {k: v for k, v in kw.items() if k != "beam_idx"}
    run = [None]

    def call():
        before = _launches()
        run[0] = engine.simulate(beam_list=blist, beam_idx=bidx, precision=precision,
                                 telescope_loc=TelescopeLocation(*SITE), **ekw)
        return tuple(a - b for a, b in zip(_launches(), before))

    cold_launches = call()
    cold = run[0]
    assert sum(cold_launches) > 0
    for _ in range(3):
        assert call() == cold_launches
        np.testing.assert_allclose(run[0], cold, rtol=0,
                                   atol=ORDER_TOL[precision] * np.abs(cold).max())
    hits = _hits()
    assert all(hits[k] > 0 for k in ("plan", "program", "input", "prepared"))


@pytest.mark.cuda
def test_cuda_device_is_part_of_the_key(cuda_device):
    """A configuration cached on the CPU runs on the card through its own
    plans, tables and kernels."""
    kw, beams, _ = _per_antenna()
    site = TelescopeLocation(*SITE)
    on_cpu = simulate_vis(beam=beams, telescope_loc=site, device="cpu", **kw)
    before = _launches()
    on_card = simulate_vis(beam=beams, telescope_loc=site, device="cuda", **kw)
    after = _launches()
    assert after[2] > before[2] and after[4] > before[4]  # beam_eval and pair_rows
    np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=1e-12 * np.abs(on_cpu).max())
