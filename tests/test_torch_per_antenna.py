"""Per-antenna beams: the port on the CPU vs ``fftvis_tpu`` and vs the exact
float64 oracle, and its new pieces against their JAX counterparts.

Same inputs on every side: hex_array(3) with its redundant baselines plus
reversed (j, i) pairs, the nside=8 HEALPix sky, fluxes from one NumPy seed
(Stokes I, or IQUV), 1 frequency x 2 times. Beams: distinct complex
variants of the committed ``tests/data/structured_dipole_100MHz.beamfits``
(``perturbed_variants``, read by each package's own reader), mapped to the
antennas by ``beam_idx``; pairs whose beams come in the other order are
stored flipped, so their visibilities take the conjugate without a feed
swap -- with identical beams that slip would not show. Tolerances,
relative to max|V|:

- port vs fftvis_tpu: 1e-9 at precision=2, 1e-4 at precision=1;
- port vs the direct oracle (DirectSimulationEngine): 1e-5 at precision=2,
  1e-4 at precision=1, the repo's gates;
- stacked evaluations and pair rows vs JAX: 1e-6 (float32), 1e-12
  (float64).

The JAX engine swaps a polarized per-antenna list for eigenbeams at 8
pairs and more (auto-rank, not ported); ``FFTVIS_AUTO_RANK=0`` keeps it
on the pair routing the port runs.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fftvis_tpu import TelescopeLocation as JaxLocation
from fftvis_tpu.beams import ShortDipoleBeam as JaxShortDipole
from fftvis_tpu.beams import interface as jax_interface
from fftvis_tpu.beams import io as jax_io
from fftvis_tpu.beams import synth as jax_synth
from fftvis_tpu.core import beams as jax_core_beams
from fftvis_tpu.core import coherency as jax_coh
from fftvis_tpu.core import utils as jax_utils
from fftvis_tpu.reference.direct_engine import DirectSimulationEngine
from fftvis_tpu.tpu import program as jax_program
from fftvis_tpu.tpu.engine import TPUSimulationEngine
from fftvis_tpu.wrapper import prepare_beam_list as jax_prepare_beam_list
from fftvis_tpu_torch import CUDASimulationEngine, TelescopeLocation
from fftvis_tpu_torch.beams import ShortDipoleBeam, perturbed_variants, read_beamfits
from fftvis_tpu_torch.beams import eval as eval_mod
from fftvis_tpu_torch.beams.interface import prepare_beams, stack_prepared
from fftvis_tpu_torch.core import utils as core_utils
from fftvis_tpu_torch.core.beams import plan_beam_pairs
from fftvis_tpu_torch.core.coherency import build_coherency
from fftvis_tpu_torch.core.utils import get_pos_reds
from fftvis_tpu_torch.cuda import engine as engine_mod
from fftvis_tpu_torch.cuda.engine import pair_routing
from fftvis_tpu_torch.cuda.planning import SimPlan
from fftvis_tpu_torch.cuda.program import Routing
from fftvis_tpu_torch.geometry import hex_array
from fftvis_tpu_torch.nufft.type1 import Type1ExactExecutor, plan_type1_exact
from fftvis_tpu_torch.utils import healpix_radec
from fftvis_tpu_torch.wrapper import prepare_beam_list

ASSET = str(Path(__file__).resolve().parent / "data" / "structured_dipole_100MHz.beamfits")
SITE = (np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
FREQS = np.array([1.0e8])
VS_REFERENCE = {2: 1e-9, 1: 1e-4}
VS_ORACLE = {2: 1e-5, 1: 1e-4}
KERNEL_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}


@pytest.fixture(autouse=True)
def _pair_routing_on_both_sides(monkeypatch):
    monkeypatch.setenv("FFTVIS_AUTO_RANK", "0")


def _variants(k):
    """(port, fftvis_tpu) lists of k distinct complex variants of the asset."""
    return (perturbed_variants(read_beamfits(ASSET), k),
            jax_synth.perturbed_variants(jax_io.read_beamfits(ASSET), k))


# Beams a pattern takes: with 'skewed', 11 pairs of very unequal size.
NBEAMS = {"cycle": 3, "skewed": 5}


def _beam_idx(nant, pattern):
    """'cycle': antenna a takes beam a % 3 (balanced pairs: the padded
    routing); 'skewed': antennas 0-3 one beam each and the rest beam 4
    (the per-pair loop)."""
    if pattern == "cycle":
        return np.arange(nant) % NBEAMS[pattern]
    idx = np.full(nant, NBEAMS[pattern] - 1)
    idx[: NBEAMS[pattern] - 1] = np.arange(NBEAMS[pattern] - 1)
    return idx


def _inputs(pattern="cycle", iquv=False, **extra):
    ants = hex_array(3)
    reds = [red[0] for red in get_pos_reds(ants, include_autos=True)]
    ra, dec = healpix_radec(8)
    rng = np.random.default_rng(0)
    flux = rng.uniform(0.1, 1.0, (ra.size, FREQS.size))
    if iquv:
        flux = np.stack([flux, *(rng.uniform(-0.05, 0.05, (3, ra.size, FREQS.size)))], axis=-1)
    return dict(
        ants=ants, ra=ra, dec=dec, fluxes=flux, freqs=FREQS,
        times=2459863.2 + np.linspace(0, 0.01, 2),
        baselines=reds + [(j, i) for (i, j) in reds[1:8]],
        beam_idx=_beam_idx(len(ants), pattern),
        **extra,
    )


def _beam_lists(beams, jbeams, kw, polarized):
    """(port, fftvis_tpu) engine beam lists through each wrapper's
    prepare_beam_list."""
    args = (FREQS, polarized, None, "x", len(kw["ants"]), kw["beam_idx"])
    return prepare_beam_list(beams, *args)[0], jax_prepare_beam_list(jbeams, *args)[0]


def _three_ways(mode, precision, beams, jbeams, kw, polarized):
    pbl, jbl = _beam_lists(beams, jbeams, kw, polarized)
    kw = dict(kw, precision=precision, polarized=polarized)
    got = CUDASimulationEngine(nufft_mode=mode, device="cpu").simulate(
        beam_list=pbl, telescope_loc=TelescopeLocation(*SITE), **kw)
    want = TPUSimulationEngine(nufft_mode=mode).simulate(
        beam_list=jbl, telescope_loc=JaxLocation(*SITE), **kw)
    oracle = DirectSimulationEngine().simulate(
        beam_list=jbl, telescope_loc=JaxLocation(*SITE), **kw)
    return got, want, oracle


def _check(got, want, oracle, precision):
    scale = np.abs(oracle).max()
    assert got.shape == want.shape == oracle.shape
    assert got.dtype == want.dtype
    assert np.abs(got - want).max() / scale <= VS_REFERENCE[precision]
    assert np.abs(got - oracle).max() / scale <= VS_ORACLE[precision]


# ----------------------------------------------------------- host copies

@pytest.mark.parametrize("case", ["coefs and idx", "ambiguous", "length", "range",
                                  "inferred", "one beam"])
def test_validate_beam_idx_matches_reference(case):
    args = {
        "coefs and idx": (np.zeros(4, int), np.ones((4, 1, 1)), 2, 4),
        "ambiguous": (None, None, 2, 4),
        "length": (np.zeros(3, int), None, 2, 4),
        "range": (np.array([0, 1, 2, 1]), None, 2, 4),
        "inferred": (None, None, 4, 4),
        "one beam": (None, None, 1, 4),
    }[case]
    try:
        want = jax_utils.validate_beam_idx(*args)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            core_utils.validate_beam_idx(*args)
        assert str(got.value) == str(err)
        return
    got = core_utils.validate_beam_idx(*args)
    assert (got is None and want is None) or np.array_equal(got, want)


def test_routing_tables_match_build_program():
    """The routing tables of both padded and per-pair routing against the
    ones ``build_program`` closes over."""
    kw = _inputs()
    for pattern, pad in (("cycle", True), ("skewed", False)):
        idx = _beam_idx(len(kw["ants"]), pattern)
        bls = kw["baselines"]
        pp = plan_beam_pairs(list(kw["ants"]), bls, idx)
        jpp = jax_core_beams.plan_beam_pairs(list(kw["ants"]), bls, idx)
        flipped = np.zeros(len(bls), dtype=bool)
        for sel, fl in zip(pp.bls_idxs, pp.flipped):
            flipped[sel] = fl
        assert flipped.any()
        assert pair_routing(pp, len(bls)) == (pad, max(len(s) for s in pp.bls_idxs))
        r = Routing(pp, flipped, *pair_routing(pp, len(bls)), "cpu")

        class _Plan:
            rotation_matrix, lattice_matrix = np.eye(3), None

        cfg = jax_program.ProgramConfig(
            plan=_Plan(), real_dtype=np.float64, complex_dtype=np.complex128,
            nbl=len(bls), nfeeds=2, npairs=jpp.npairs, pair_plan=jpp,
            flipped_global=flipped, pad_routing=pad, m_max=r.m_max,
        )
        tables = _closure(jax_program.build_program(cfg))
        assert np.array_equal(r.inv_perm.numpy(), tables["inv_perm"])
        if pad:
            assert np.array_equal(r.sel_pad, tables["sel_pad"])
            assert np.array_equal(r.flip_pad.numpy(), tables["flip_pad"])
            assert np.array_equal(r.src_pos.numpy(), tables["src_pos"])


def _closure(fn, seen=None) -> dict:
    """Every variable a function closes over, through nested closures."""
    seen = {} if seen is None else seen
    for name, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
        try:
            value = cell.cell_contents
        except ValueError:
            continue
        if name not in seen:
            seen[name] = value
            if callable(value) and hasattr(value, "__code__"):
                _closure(value, seen)
    return seen


@pytest.mark.parametrize("free", [10 * 2**30, 2**20])
def test_device_memory_check_raises_before_allocating(free, monkeypatch):
    """On a CUDA device with too little free memory the engine's check
    raises a clear MemoryError; with enough, or on the CPU, it passes."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 80 * 2**30))
    need = 4 * 2**30
    engine_mod.check_device_memory(need, "the type-3 grids", "cpu")
    if free >= need:
        engine_mod.check_device_memory(need, "the type-3 grids", "cuda")
        return
    with pytest.raises(MemoryError, match="the type-3 grids need 4.00 GiB"):
        engine_mod.check_device_memory(need, "the type-3 grids", "cuda")


def test_source_block_bounds_the_block_temporaries():
    """4096 sources a block where the temporaries fit their budget (the
    north star's 720 channels and (42, 42) modes), fewer where they would
    not; the direct path's padded routing counts P * m_max targets."""
    modes = np.array([[-20, 20, 0], [0, 3, -20]])
    ex = Type1ExactExecutor(plan_type1_exact(modes), device="cpu")
    assert ex.plan.nf == (42, 42)
    plan = SimPlan("type1", ex, None, np.eye(3), np.eye(3))
    block = engine_mod.source_block(plan, 720, 631, 180, True, 9, torch.complex128)
    assert block == engine_mod.SOURCE_BLOCK == 4096
    per_source = (2 * 100_000 + 42 * 42) * 16
    assert engine_mod.source_block(plan, 100_000, 631, 180, True, 9, torch.complex128) == (
        engine_mod.BLOCK_BYTES // per_source)
    direct = SimPlan("direct", None, np.zeros((2, 631)), np.eye(3))
    assert engine_mod.source_block(direct, 720, 631, 180, True, 9000, torch.complex128) == (
        engine_mod.DIRECT_BLOCK_BYTES // (16 * 180 * 9000))


# ---------------------------------------------------- stacks and pair rows

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order,polarized", [(1, True), (3, True), (1, False)])
def test_stacked_evaluations_match_reference(dtype, order, polarized):
    beams, jbeams = _variants(3)
    if not polarized:
        beams, jbeams = _beam_lists(beams, jbeams, _inputs(), False)
    opts = {"order": order}
    prepared = prepare_beams(beams, FREQS, polarized, spline_opts=opts, dtype=dtype,
                             device="cpu")
    stacked = stack_prepared(prepared)
    jstacked = jax_interface.stack_prepared(
        jax_interface.prepare_beams(jbeams, FREQS, polarized, spline_opts=opts))
    assert stacked.nbeams == jstacked.nbeams == 3
    assert stacked.table.shape[-1] == 3 * (8 if polarized else 2)
    rng = np.random.default_rng(order)
    az, za = rng.uniform(0, 2 * np.pi, 500), rng.uniform(0, np.pi / 2, 500)
    got = stacked.evaluate_all(torch.tensor(az, dtype=dtype), torch.tensor(za, dtype=dtype),
                               1e8, 0).numpy()
    want = np.asarray(jstacked.evaluate_all(jnp.asarray(az), jnp.asarray(za), 1e8, 0))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= KERNEL_TOL[dtype] * np.abs(want).max()


def test_mixed_list_does_not_stack():
    beams, _ = _variants(2)
    mixed = prepare_beams([ShortDipoleBeam(), beams[1]], FREQS, True, device="cpu")
    assert stack_prepared(mixed) is None
    orders = prepare_beams(beams, FREQS, True, device="cpu")
    orders[1] = prepare_beams(beams[1:], FREQS, True, spline_opts={"order": 3},
                              device="cpu")[0]
    assert stack_prepared(orders) is None


def _pair_inputs(kind, dtype, n=300, K=4, seed=0):
    rng = np.random.default_rng(seed)
    ch_shape = (1, 2) if kind == "power" else (2, 2, 2)
    evals = rng.normal(size=(n, K * int(np.prod(ch_shape))))
    if kind == "power":
        evals = np.abs(evals)
    pairs = np.array([(i, j) for i in range(K) for j in range(i, K)])
    mask = (rng.uniform(size=n) < 0.5).astype(float)
    stokes = rng.uniform(0.1, 1.0, (n, 1))
    if kind == "jones-iquv":
        sky = build_coherency(np.stack([stokes, *rng.uniform(-0.05, 0.05, (3, n, 1))],
                                       axis=-1), True)[:, 0]
    else:
        sky = stokes[:, 0]
    return evals, pairs, sky, mask, ch_shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["power", "jones-I", "jones-iquv"])
def test_pair_rows_plain_matches_batched_reference(kind, dtype):
    evals, pairs, sky, mask, ch_shape = _pair_inputs(kind, dtype)
    is_power, iquv = kind == "power", kind == "jones-iquv"
    cdt = eval_mod.COMPLEX[dtype]
    got = eval_mod.pair_rows(
        torch.tensor(evals, dtype=dtype), torch.tensor(pairs[:, 0], dtype=torch.int32),
        torch.tensor(pairs[:, 1], dtype=torch.int32),
        torch.tensor(sky, dtype=cdt if iquv else dtype), torch.tensor(mask, dtype=dtype),
        ch_shape, is_power, iquv, feed=1).numpy()
    # The JAX side: the stacked responses as evaluate_all gives them, then
    # the batched rows and the mask, in float64.
    resp = evals.T.reshape((-1,) + ch_shape + (evals.shape[0],))
    resp = resp[:, 0, 1] if is_power else resp[:, 0] + 1j * resp[:, 1]
    want = np.asarray(jax_coh.apparent_coherency_rows_batched(
        jnp.asarray(resp), pairs[:, 0], pairs[:, 1], jnp.asarray(sky), not is_power,
        iquv)) * mask[None, :]
    assert got.shape == want.shape == (len(pairs) * (1 if is_power else 4), evals.shape[0])
    assert np.abs(got - want).max() <= KERNEL_TOL[dtype] * np.abs(want).max()


# --------------------------------------------------------- end to end

@pytest.mark.parametrize("precision", [2, 1])
@pytest.mark.parametrize("mode,sky,pattern", [
    ("direct", "polarized", "cycle"), ("direct", "polarized", "skewed"),
    ("direct", "unpolarized", "cycle"), ("direct", "iquv", "cycle"),
    ("type3", "polarized", "cycle"), ("type3", "polarized", "skewed"),
    ("type3", "unpolarized", "skewed"), ("type3", "iquv", "cycle"),
])
def test_per_antenna_engine_matches_reference_and_oracle(mode, sky, pattern, precision):
    """Distinct complex variants with flipped baselines, through the
    engines with the transform forced: the direct path or type-3 (every
    kernel of the port's path, the per-pair interpolation subsets)."""
    polarized = sky != "unpolarized"
    kw = _inputs(pattern=pattern, iquv=sky == "iquv")
    beams, jbeams = _variants(NBEAMS[pattern])
    got, want, oracle = _three_ways(mode, precision, beams, jbeams, kw, polarized)
    nbl = len(kw["baselines"])
    assert got.shape == ((1, 2, 2, 2, nbl) if polarized else (1, 2, nbl))
    _check(got, want, oracle, precision)


@pytest.mark.parametrize("mode", ["direct", "type3"])
def test_mixed_analytic_and_tabulated_list(mode):
    """A list that does not stack (an analytic dipole and a table) goes
    beam by beam, as in JAX."""
    beams, jbeams = _variants(3)
    kw = _inputs()
    got, want, oracle = _three_ways(mode, 2, [ShortDipoleBeam(), *beams[1:]],
                                    [JaxShortDipole(), *jbeams[1:]], kw, True)
    _check(got, want, oracle, 2)


def test_flipped_baselines_conjugate_without_feed_swap():
    """A baseline and its reverse, with distinct complex beams. Between two
    antennas of one beam, (j, i) is the conjugate of (i, j) with the feeds
    swapped, as physics has it; between two beams one of the two is stored
    flipped, and the reference's convention gives the conjugate WITHOUT a
    feed swap. The port keeps both, and matches the oracle."""
    kw = _inputs()
    beams, jbeams = _variants(3)
    got, _, oracle = _three_ways("direct", 2, beams, jbeams, kw, True)
    bls, idx = kw["baselines"], kw["beam_idx"]
    pos = {b: k for k, b in enumerate(bls)}
    kinds = set()
    for (i, j) in bls:
        if i == j or (j, i) not in pos or (j, i) < (i, j):
            continue
        a, b = got[..., pos[(i, j)]], got[..., pos[(j, i)]]
        same_beam = idx[i] == idx[j]
        kinds.add(same_beam)
        want = np.conj(np.swapaxes(a, 2, 3) if same_beam else a)
        np.testing.assert_allclose(b, want, rtol=0, atol=1e-12 * np.abs(got).max())
    assert kinds == {True, False}
    scale = np.abs(oracle).max()
    assert np.abs(got - oracle).max() / scale <= VS_ORACLE[2]


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [37, 331])
@pytest.mark.parametrize("n", [4096, 471])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["power", "jones-I", "jones-iquv"])
def test_cuda_pair_rows_matches_plain(cuda_device, kind, dtype, n, K):
    """K = 37 stages a tile's evaluations in shared memory; K = 331 (one
    beam per antenna of HERA-331) takes the global-memory form for the
    Jones stacks, while a power stack still fits shared memory."""
    evals, pairs, sky, mask, ch_shape = _pair_inputs(kind, dtype, n=n, K=K)
    pairs = pairs[:: max(1, len(pairs) // 180)]
    iquv, cdt = kind == "jones-iquv", eval_mod.COMPLEX[dtype]
    args = (torch.tensor(evals, dtype=dtype, device=cuda_device),
            torch.tensor(pairs[:, 0], dtype=torch.int32, device=cuda_device),
            torch.tensor(pairs[:, 1], dtype=torch.int32, device=cuda_device),
            torch.tensor(sky, dtype=cdt if iquv else dtype, device=cuda_device),
            torch.tensor(mask, dtype=dtype, device=cuda_device))
    before = eval_mod.pair_launches
    got = eval_mod.pair_rows(*args, ch_shape, kind == "power", iquv, feed=1)
    assert eval_mod.pair_launches == before + 1
    want = eval_mod.pair_rows_plain(*args, ch_shape, kind == "power", iquv, feed=1)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= KERNEL_TOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 3])
def test_cuda_stacked_beam_eval_matches_plain(cuda_device, order):
    """The north-star stack's shape, (91, 360, 37 x 8)."""
    rng = np.random.default_rng(order)
    data = torch.tensor(rng.normal(size=(91, 360, 296)), dtype=torch.float32,
                        device=cuda_device)
    y = torch.tensor(rng.uniform(0, 90, 4096), dtype=torch.float32, device=cuda_device)
    x = torch.tensor(rng.uniform(0, 360, 4096), dtype=torch.float32, device=cuda_device)
    got = eval_mod.beam_eval(data, y, x, order=order, wrap_x=True)
    want = eval_mod.beam_eval_plain(data, y, x, order=order, wrap_x=True)
    assert (got - want).abs().max().item() <= 2e-6 * want.abs().max().item()
