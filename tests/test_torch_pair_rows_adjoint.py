"""The adjoint of ``pair_rows`` in its evaluations, and the table gradient
of the stacked beam's interpolation, against the JAX package.

``pair_rows_adjoint_plain``, the autograd of ``pair_rows_plain``, is the
derivative of every beam pair's masked coherency rows. It is held to
``jax.grad`` of the JAX package's own rows --
``fftvis_tpu.core.coherency.apparent_coherency_rows_batched`` times the
mask -- through the real loss ``Re sum conj(W) rows`` for a W made from
a NumPy seed, taken with respect to the evaluations as one real array (the
re/im channels as the port's stacked table lays them out), so neither
package's complex convention enters. Cases: the power, Jones x Stokes I and
Jones x IQUV epilogues, complex and real Jones tables, float32 and float64,
K = 5 beams with all K(K+1)/2 pairs and an ordered list with repeats, every
point unmasked or about half masked. Power evaluations are drawn positive:
where e_i e_j <= 0 the port's floor has a zero slope, a documented
divergence. Tolerances relative to max|grad|: 1e-12 (float64), 1e-5
(float32). The same function meets the dot-product identity with the
forward-mode derivative (``torch.func.jvp``) of ``pair_rows_plain``, and
``PairRowsFunction`` on the CPU is it.

On a CUDA card (marked ``cuda``; skipped without one): the adjoint
kernel against the plain version, in the form the host picks (the tile
form at K = 37, the wide form at 331) and in every form that takes the
shapes, bitwise repeatable; the Function
launches it once and never calls ``pair_rows_plain`` on the card; the
redesigned ``beam_eval_adjoint_points`` writes every table cell (the cells
no point touches are exactly 0 after the caching allocator was filled with
NaN) and repeats bitwise.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fftvis_tpu.core import coherency as jax_coh
from fftvis_tpu_torch.beams import eval as eval_mod
from fftvis_tpu_torch.core.coherency import apparent_coherency_rows_batched, build_coherency
from fftvis_tpu_torch.cuda.program import Routing

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
NP = {torch.float32: np.float32, torch.float64: np.float64}
# (epilogue, Jones table): ch_shape and whether the rows are a power beam's.
CASES = {
    "power": ((1, 2), True, False),
    "jones-I": ((2, 2, 2), False, False),
    "jones-I-real": ((2, 2), False, False),
    "jones-iquv": ((2, 2, 2), False, True),
    "jones-iquv-real": ((2, 2), False, True),
}
K5 = 5
PAIR_LISTS = {
    "triangle": [(i, j) for i in range(K5) for j in range(i, K5)],
    "repeats": [(3, 1), (0, 0), (3, 1), (4, 2), (2, 4), (1, 1), (0, 3), (4, 4)],
}
FEED = 1


def _inputs(case, pairs, masked, dtype, seed, n=23, K=K5):
    """Seeded NumPy evaluations (n, K * chf), pairs, sky, mask and W."""
    ch_shape, is_power, iquv = CASES[case]
    rng = np.random.default_rng(seed)
    chf = math.prod(ch_shape)
    if is_power:
        evals = rng.uniform(0.2, 1.0, (n, K * chf))
    else:
        evals = rng.normal(size=(n, K * chf))
    pairs = np.asarray(pairs)
    mask = (rng.uniform(size=n) < 0.5) if masked else np.ones(n, dtype=bool)
    stokes = rng.uniform(0.1, 1.0, (n, 1))
    if iquv:
        sky = build_coherency(np.stack([stokes, *rng.uniform(-0.3, 0.3, (3, n, 1))], axis=-1),
                              True)[:, 0]
    else:
        sky = stokes[:, 0]
    C = 1 if is_power else 4
    W = rng.normal(size=(len(pairs) * C, n)) + 1j * rng.normal(size=(len(pairs) * C, n))
    rdt = NP[dtype]
    return (evals.astype(rdt), pairs, sky.astype(np.complex64 if rdt == np.float32 else
                                                 np.complex128) if iquv else sky.astype(rdt),
            mask.astype(rdt), W.astype(np.complex64 if rdt == np.float32 else np.complex128))


def _torch_args(evals, pairs, sky, mask, W, device="cpu"):
    return (torch.tensor(evals, device=device),
            torch.tensor(pairs[:, 0], dtype=torch.int32, device=device),
            torch.tensor(pairs[:, 1], dtype=torch.int32, device=device),
            torch.tensor(sky, device=device), torch.tensor(mask, device=device),
            torch.tensor(W, device=device))


def _jax_grad(case, evals, pairs, sky, mask, W):
    """jax.grad of Re sum conj(W) (rows * mask) in the evaluations, the rows
    the JAX package's batched coherency of the responses as its stacked
    beams give them (``BatchedPreparedBeams.evaluate_all``)."""
    ch_shape, is_power, iquv = CASES[case]
    n = evals.shape[0]

    def loss(ev):
        vals = ev.T.reshape((-1,) + ch_shape + (n,))
        if is_power:
            resp = vals[:, 0, FEED]
        elif len(ch_shape) == 3:
            resp = vals[:, 0] + 1j * vals[:, 1]
        else:
            resp = vals
        rows = jax_coh.apparent_coherency_rows_batched(
            resp, pairs[:, 0], pairs[:, 1], jnp.asarray(sky), not is_power, iquv)
        return jnp.real(jnp.sum(jnp.conj(jnp.asarray(W)) * rows * jnp.asarray(mask)[None, :]))

    return np.asarray(jax.grad(loss)(jnp.asarray(evals)))


def _port_plain(case, args):
    ch_shape, is_power, iquv = CASES[case]
    return eval_mod.pair_rows_adjoint_plain(*args, ch_shape, is_power, iquv, feed=FEED)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pairs", list(PAIR_LISTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_adjoint_matches_jax_grad(case, dtype, pairs, masked):
    inputs = _inputs(case, PAIR_LISTS[pairs], masked, dtype, seed=len(case) + 7 * masked)
    want = _jax_grad(case, *inputs)
    got = _port_plain(case, _torch_args(*inputs)).numpy()
    assert got.shape == want.shape == inputs[0].shape
    assert got.dtype == inputs[0].dtype
    assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()


@pytest.mark.parametrize("pairs", list(PAIR_LISTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_adjoint_is_autograd_of_plain_rows(case, dtype, pairs):
    """The dot-product identity with forward-mode autodiff of the plain
    rows: <W, J d> = <adjoint W, d> for a seeded direction d, relative to
    sum |adjoint W| |d|."""
    ch_shape, is_power, iquv = CASES[case]
    args = _torch_args(*_inputs(case, PAIR_LISTS[pairs], True, dtype, seed=3))
    d = torch.tensor(np.random.default_rng(4).normal(size=args[0].shape), dtype=dtype)
    _, Jd = torch.func.jvp(
        lambda e: eval_mod.pair_rows_plain(e, *args[1:5], ch_shape, is_power, iquv, feed=FEED),
        (args[0],), (d,))
    got = _port_plain(case, args)
    lhs, rhs = (args[5].conj() * Jd).real.sum(), (got * d).sum()
    assert (lhs - rhs).abs() <= TOL[dtype] * (got.abs() * d.abs()).sum()


@pytest.mark.parametrize("case", list(CASES))
def test_pair_rows_function_backward_is_the_adjoint(case):
    """On the CPU the Function's gradient in the evaluations is the plain
    adjoint, and its sky gradient the unit-sky rerun's."""
    ch_shape, is_power, iquv = CASES[case]
    args = _torch_args(*_inputs(case, PAIR_LISTS["repeats"], True, torch.float64, seed=5))
    ev, sky = args[0].clone().requires_grad_(), args[3].clone().requires_grad_()
    rows = eval_mod.pair_rows(ev, args[1], args[2], sky, args[4], ch_shape, is_power, iquv,
                              feed=FEED)
    gev, gsky = torch.autograd.grad(rows, (ev, sky), args[5])
    assert torch.equal(gev, _port_plain(case, args))
    sk = args[3].clone().requires_grad_()
    plain_rows = eval_mod.pair_rows_plain(args[0], args[1], args[2], sk, args[4], ch_shape,
                                          is_power, iquv, feed=FEED)
    (want,) = torch.autograd.grad(plain_rows, sk, args[5])
    assert (gsky - want).abs().max() <= 1e-12 * want.abs().max()


# More pairs than one chunk of the tile kernel: 3 chunks, strided.
LONG_PAIRS = [(i % K5, (3 * i + 1) % K5) for i in range(37)]


@pytest.mark.parametrize("pairs", list(PAIR_LISTS) + ["long"])
def test_pair_index_lists_every_role(pairs):
    """Beam k's entries are the pairs where it is first (e < P) and then
    where it is second (e >= P), each in the tile kernel's chunk order (pair
    q in chunk q % nch, slot q // nch); a beam past the last index has
    none."""
    p = np.asarray(LONG_PAIRS if pairs == "long" else PAIR_LISTS[pairs])
    P, nbeams = len(p), K5 + 2
    idx = eval_mod.pair_index(torch.tensor(p[:, 0], dtype=torch.int32),
                              torch.tensor(p[:, 1], dtype=torch.int32), nbeams)
    assert idx.dtype == torch.int32 and idx.shape == (nbeams + 1 + 2 * P,)
    off, ent = idx[:nbeams + 1].tolist(), idx[nbeams + 1:].tolist()
    nch = -(-P // eval_mod.PAIR_ADJ_CHUNK)

    def chunk_order(qs):
        return sorted(qs, key=lambda q: (q % nch, q // nch))

    for k in range(nbeams):
        want = (chunk_order([q for q in range(P) if p[q, 0] == k])
                + [P + q for q in chunk_order([q for q in range(P) if p[q, 1] == k])])
        assert ent[off[k]:off[k + 1]] == want


def test_routing_keeps_the_pair_index():
    """The engine's routing builds the index once, on its device."""
    from fftvis_tpu_torch.core.beams import plan_beam_pairs

    beam_idx = np.array([0, 1, 2, 1, 0])
    bls = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0), (1, 1)]
    pp = plan_beam_pairs(list(range(5)), bls, beam_idx)
    r = Routing(pp, np.zeros(len(bls), dtype=bool), False, 0, "cpu")
    want = eval_mod.pair_index(r.pair_i, r.pair_j, 1 + max(max(q) for q in r.pairs))
    assert torch.equal(r.pair_index, want)


@pytest.mark.parametrize("kind", ["tensor", "list", "array"])
def test_batched_rows_take_indices_of_any_kind(kind):
    """apparent_coherency_rows_batched indexes with a tensor as it is (on
    its device, no host round trip), and uploads a list or an array."""
    rng = np.random.default_rng(2)
    evals = torch.tensor(rng.normal(size=(4, 2, 2, 9)) + 1j * rng.normal(size=(4, 2, 2, 9)))
    flux = torch.tensor(rng.uniform(size=9))
    ii, jj = [0, 3, 1], [2, 3, 0]
    conv = {"tensor": lambda a: torch.tensor(a, dtype=torch.int32), "list": list,
            "array": np.asarray}[kind]
    got = apparent_coherency_rows_batched(evals, conv(ii), conv(jj), flux, True, False)
    want = np.asarray(jax_coh.apparent_coherency_rows_batched(
        jnp.asarray(evals.numpy()), np.array(ii), np.array(jj), jnp.asarray(flux.numpy()),
        True, False))
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_adjoint_refuses_a_wrong_gradient():
    args = _torch_args(*_inputs("jones-I", PAIR_LISTS["repeats"], False, torch.float64, 1))
    with pytest.raises(ValueError, match="gradient must be"):
        eval_mod.pair_rows_adjoint(*args[:5], args[5][:-1], (2, 2, 2), False)
    with pytest.raises(ValueError, match="gradient must be"):
        eval_mod.pair_rows_adjoint(*args[:5], args[5].to(torch.complex64), (2, 2, 2), False)


@pytest.mark.parametrize("kernel", ["beam_eval_adjoint_points", "pair_rows_adjoint_wide",
                                    "pair_rows_adjoint_tile"])
def test_adjoint_kernels_own_their_outputs(kernel):
    """Neither adjoint kernel adds into its output with an atomic: the table
    gradient's tiles and the evaluations' gradient are each written once,
    by one thread, so the wrappers allocate them uninitialised."""
    src = (Path(eval_mod.__file__).resolve().parent.parent / "csrc" / "beam_eval.cu").read_text()
    start = re.search(rf"__global__ void __launch_bounds__\([^)]*\) {kernel}\(", src).start()
    body = src[start:src.index("\n}\n", start)]
    assert "atomic" not in body


# Pair lists of the form rule's cases: the north star's 180 pairs of 37
# beams, every pair of 48 and of 49 beams (the tile form's last and first
# beam count past its thread rows), and one beam an antenna of HERA-331
# (631 redundant representatives).
RULE_PAIRS = {37: 180, 48: 48 * 49 // 2, 49: 49 * 50 // 2, 331: 631}
RULE_CH = {"power": ((1, 2), 1), "jones-I": ((2, 2, 2), 4), "jones-iquv": ((2, 2, 2), 4)}


def _rule_fits(K, epilogue, itemsize, adjoint):
    """The forms that take the cases, as the kernels' rule
    (``fftvis_pair_rows_smem``) has them: the forward's 32-point tile holds
    K x chf x 33 reals in 200 KiB (every case but the 331 Jones beams), its
    staged wide form a tile's rows up to ~450 complex Jones beams, and its
    other wide form any stack; the adjoint's tile takes at most 48 beams
    and 224 KiB (48 complex Jones beams in float64 need 232 KiB), its wide
    form any stack."""
    jones = epilogue != "power"
    if not adjoint:
        return ["wide", "wide-global"] if K == 331 and jones else ["tile", "wide", "wide-global"]
    return ["tile", "wide"] if K <= 48 and not (K == 48 and jones and itemsize == 8) else ["wide"]


def _given_smem(fits):
    """Shared-memory byte counts of the forms, -1 for those not in ``fits``."""
    return {f: (1024 * (i + 1) if f in fits else -1) for i, f in enumerate(eval_mod.PAIR_FORMS)}


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("epilogue", list(RULE_CH))
@pytest.mark.parametrize("K", list(RULE_PAIRS))
def test_pair_rows_form_rule(K, epilogue, itemsize, adjoint):
    """The host's pick of pair_rows' (and its adjoint's) form from the
    kernels' shared memory at the cases' byte counts: the first form of
    PAIR_FORMS that takes the shapes -- the tile wherever it fits, else the
    staged wide form, in either dtype."""
    fits = _rule_fits(K, epilogue, itemsize, adjoint)
    want = "tile" if "tile" in fits else "wide"
    assert eval_mod.pair_rows_form(_given_smem(fits)) == want
    assert eval_mod._pick_form(None, _given_smem(fits), "pair_rows") == eval_mod.PAIR_FORMS[want]


def test_pair_rows_form_rule_past_shared_memory():
    """2,000 complex Jones beams in float64: the forward's staged rows (past
    ~450 beams) no longer fit shared memory, so it reads them from device
    memory. Where no form fits the pick raises, and so does a form asked
    for that cannot take the shapes or does not exist."""
    assert eval_mod.pair_rows_form(_given_smem(["wide-global"])) == "wide-global"
    with pytest.raises(ValueError, match="no form takes"):
        eval_mod.pair_rows_form(_given_smem([]))
    smem = _given_smem(["wide"])
    assert eval_mod._pick_form("wide", smem, "pair_rows_adjoint") == eval_mod.PAIR_FORMS["wide"]
    for form in ("tile", "wide-global", "global"):
        with pytest.raises(ValueError, match="cannot take"):
            eval_mod._pick_form(form, smem, "pair_rows_adjoint")


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _north_star_pairs(K, P, rng):
    """P distinct (i <= j) pairs of K beams, drawn as the north star's
    180 of 37 are: every i <= j pair, thinned evenly."""
    tri = np.array([(i, j) for i in range(K) for j in range(i, K)])
    return tri[np.linspace(0, len(tri) - 1, min(P, len(tri))).astype(int)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["K37-n4096", "K37-n4000-half", "K331-n4096-half"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_pair_rows_adjoint_matches_plain(cuda_device, case, dtype, shape):
    """K = 37 takes the tile form (the evaluations and the gradient rows
    in shared memory); K = 331 (a beam an antenna of HERA-331) takes the
    wide form (a tile of one sector's points, its rows in shared memory).
    The ragged 4000-point block ends on a partial tile."""
    K, n, masked = {"K37-n4096": (37, 4096, False), "K37-n4000-half": (37, 4000, True),
                    "K331-n4096-half": (331, 4096, True)}[shape]
    ch_shape, is_power, iquv = CASES[case]
    pairs = _north_star_pairs(K, 180 if K == 37 else 631, np.random.default_rng(K))
    inputs = _inputs(case, pairs, masked, dtype, seed=K + n, n=n, K=K)
    args = _torch_args(*inputs, device=cuda_device)
    counter = "pair_adjoint_wide_launches" if K == 331 else "pair_adjoint_launches"
    before = getattr(eval_mod, counter)
    got = eval_mod.pair_rows_adjoint(*args, ch_shape, is_power, iquv, feed=FEED)
    assert getattr(eval_mod, counter) == before + 1
    want = eval_mod.pair_rows_adjoint_plain(*args, ch_shape, is_power, iquv, feed=FEED)
    assert (got - want).abs().max().item() <= TOL[dtype] * want.abs().max().item()
    again = eval_mod.pair_rows_adjoint(*args, ch_shape, is_power, iquv, feed=FEED)
    assert torch.equal(got, again)


def _hub_pairs(K, P, rng):
    """P distinct (i <= j) pairs of K beams with a hub, as a redundant
    array's representatives have one (antenna 0 of HERA-331 is in 332 of
    its 631): every (0, j), then other pairs drawn at random."""
    hub = [(0, j) for j in range(K)]
    rest = [(i, j) for i in range(1, K) for j in range(i, K)]
    pick = rng.choice(len(rest), size=max(0, P - K), replace=False)
    return np.array(hub + [rest[i] for i in sorted(pick)])


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["wide", "wide-global"])
@pytest.mark.parametrize("shape", ["K37-n4000-half", "K331-hub-n163-half", "K331-hub-n4096"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_wide_forms_match_plain(cuda_device, case, dtype, shape, form):
    """Both wide forms of the rows, forced, and the adjoint's wide form
    against the plain versions: at K = 37 (where the rule picks the tile),
    and at K = 331 with a hub beam in 331 of 631 pairs (its entries span
    the adjoint's rounds) on a ragged 163-point block (the beams split
    over several blocks of a tile) and a full one; the adjoint bitwise
    repeatable."""
    K, pairs, n, masked = {
        "K37-n4000-half": (37, _north_star_pairs(37, 180, np.random.default_rng(3)), 4000, True),
        "K331-hub-n163-half": (331, _hub_pairs(331, 631, np.random.default_rng(4)), 163, True),
        "K331-hub-n4096": (331, _hub_pairs(331, 631, np.random.default_rng(5)), 4096, False),
    }[shape]
    ch_shape, is_power, iquv = CASES[case]
    args = _torch_args(*_inputs(case, pairs, masked, dtype, seed=K + n, n=n, K=K),
                       device=cuda_device)
    epi = _epilogue(is_power, iquv)
    got = eval_mod._pair_rows_cuda(*args[:5], ch_shape, epi, FEED, form)
    want = eval_mod.pair_rows_plain(*args[:5], ch_shape, is_power, iquv, feed=FEED)
    assert (got - want).abs().max().item() <= TOL[dtype] * want.abs().max().item()
    index = eval_mod.pair_index(args[1], args[2], K)

    def adjoint():
        return eval_mod._pair_rows_adjoint_cuda(*args[:3], index, *args[3:], ch_shape, epi,
                                                FEED, K, "wide")

    got = adjoint()
    want = _port_plain(case, args)
    assert (got - want).abs().max().item() <= TOL[dtype] * want.abs().max().item()
    assert torch.equal(got, adjoint())


def _epilogue(is_power, iquv):
    return eval_mod.POWER if is_power else (eval_mod.JONES_IQUV if iquv else eval_mod.JONES_I)


@pytest.mark.cuda
def test_cuda_pair_rows_form_rule_is_the_library_rule(cuda_device):
    """The kernels' own shared-memory rule (``fftvis_pair_rows_smem``,
    through pair_rows_smem) refuses and takes the forms the CPU rule test
    gives it at its cases, and past ~450 Jones beams leaves the forward
    only its unstaged wide form; a form asked for that cannot take the
    shapes raises."""
    for K, P in RULE_PAIRS.items():
        for epilogue, (ch_shape, C) in RULE_CH.items():
            for dtype in (torch.float32, torch.float64):
                for adjoint in (False, True):
                    smem = eval_mod.pair_rows_smem(adjoint, K, math.prod(ch_shape), P, K, C,
                                                   dtype)
                    fits = [f for f in eval_mod.PAIR_FORMS if smem[f] >= 0]
                    assert fits == _rule_fits(K, epilogue, dtype.itemsize, adjoint), \
                        (K, epilogue, dtype, adjoint, smem)
    for dtype in (torch.float32, torch.float64):
        smem = eval_mod.pair_rows_smem(False, 2000, 8, 631, 2000, 4, dtype)
        assert eval_mod.pair_rows_form(smem) == "wide-global"
    args = _torch_args(*_inputs("jones-I", _north_star_pairs(331, 631, np.random.default_rng(0)),
                                True, torch.float64, seed=1, n=64, K=331), device=cuda_device)
    with pytest.raises(ValueError, match="cannot take"):
        eval_mod._pair_rows_cuda(*args[:5], (2, 2, 2), eval_mod.JONES_I, 0, "tile")


@pytest.mark.cuda
def test_cuda_pair_rows_function_runs_no_plain(cuda_device):
    """The Function's backward on the card: one adjoint launch on the
    given index, no pair_rows_plain, the plain adjoint's values."""
    K, n = 37, 4096
    pairs = _north_star_pairs(K, 180, np.random.default_rng(0))
    args = _torch_args(*_inputs("jones-I", pairs, True, torch.float64, seed=9, n=n, K=K),
                       device=cuda_device)
    index = eval_mod.pair_index(args[1], args[2], K)
    ev = args[0].clone().requires_grad_()
    rows = eval_mod.pair_rows(ev, *args[1:5], (2, 2, 2), False, False, index=index)
    plain, launches = eval_mod.pair_plain_cuda_calls, eval_mod.pair_adjoint_launches
    (got,) = torch.autograd.grad(rows, ev, args[5])
    assert eval_mod.pair_plain_cuda_calls == plain
    assert eval_mod.pair_adjoint_launches == launches + 1
    want = eval_mod.pair_rows_adjoint_plain(*args, (2, 2, 2), False, False)
    assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", [1, 3])
def test_cuda_beam_eval_adjoint_writes_every_cell(cuda_device, order, dtype):
    """The table gradient comes from torch.empty: after the caching
    allocator's blocks were filled with NaN, the cells no point touches
    read exactly 0, the rest match the plain adjoint, and a second run is
    bitwise equal."""
    rng = np.random.default_rng(order)
    ny, nx, ch = 91, 360, 40
    data = torch.tensor(rng.normal(size=(ny, nx, ch)), dtype=dtype, device=cuda_device)
    # Points in the table's upper half only, some on the azimuth seam.
    y = torch.tensor(rng.uniform(0, 40, 3000), dtype=dtype, device=cuda_device)
    x = torch.tensor(np.r_[rng.uniform(0, 360, 2990), 359.5 + rng.uniform(0, 0.5, 10)],
                     dtype=dtype, device=cuda_device)
    g = torch.tensor(rng.normal(size=(3000, ch)), dtype=dtype, device=cuda_device)
    junk = torch.full((8 * ny * nx * ch,), float("nan"), dtype=dtype, device=cuda_device)
    del junk  # back to the caching allocator, NaN-filled
    got, _, _ = eval_mod.beam_eval_adjoint(data, y, x, g, order, True)
    assert torch.isfinite(got).all()
    assert (got[60:] == 0).all()  # rows no tap reaches
    want, _, _ = eval_mod.beam_eval_adjoint_plain(data, y, x, g, order, True)
    assert (got - want).abs().max().item() <= TOL[dtype] * want.abs().max().item()
    again, _, _ = eval_mod.beam_eval_adjoint(data, y, x, g, order, True)
    assert torch.equal(got, again)
