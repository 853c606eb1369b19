"""The bin orders of the d = 3 binned-tile kernels, on the CPU.

- ``interp.bin_order_3d`` (the plan-time target order of ``interp_sm_3d``)
  against a NumPy brute force over seeds and widths 2..16: the permutation
  sorts the targets stably by the bin of their first tap cell, the offsets
  cut every bin into pieces of at most ``SUBPROBLEM`` targets, and no order
  is planned on a grid with an axis shorter than the padded tile, for
  tables that are not consecutive cells, or where the choice (``_sm_pays``:
  too few targets a bin, or bins whose cells stay in cache) finds
  ``interp_taps_nd`` faster; the bin edges read from ``csrc/bins.cuh`` are
  the header's rule;
- ``spread.bin_sort_3d`` (the plain version of ``spread_sm_3d``'s device
  bin sort) and ``bin_keys_3d`` against the same brute force, with
  coordinates on and around the wrap;
- the executors' d = 3 interpolation through the bin-ordered tables and the
  inverse permutation against ``fftvis_tpu``'s (type-3 and type-2, 1e-13);
- spreading in bin order equals the unsorted plain spread (1e-13);
- the trimmed checks of ``interp_nd`` and ``spread_nd`` raise as before.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fftvis_tpu import nufft as jnufft
from fftvis_tpu.nufft import transform as jax_transform
from fftvis_tpu_torch.nufft import interp as interp_mod
from fftvis_tpu_torch.nufft import spread as spread_mod
from fftvis_tpu_torch.nufft.kernels import es_kernel_grid
from fftvis_tpu_torch.nufft.transform import (
    Type2Executor,
    Type3Executor,
    plan_type2,
    plan_type3,
)


def _tables(first, nf, w):
    """Plan-like (m, w) tables: w consecutive cells (mod nf) from ``first``."""
    return [np.mod(f[:, None] + np.arange(w)[None, :], n).astype(np.int32)
            for f, n in zip(first, nf)]


def _brute_keys(first, nf, edge):
    nb = [-(-n // edge) for n in nf]
    return ((first[0] // edge) * nb[1] + first[1] // edge) * nb[2] + first[2] // edge


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


# ------------------------------------------------ the host order of interp

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("w", [2, 5, 8, 11, 14, 16])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_bin_order_matches_brute_force(w, seed, itemsize):
    rng = np.random.default_rng(seed)
    edge = interp_mod.bin_edge_3d(w, itemsize)
    P = edge + w - 1
    nf = tuple(int(v) for v in rng.integers(P, P + 40, 3))
    m = int(0.3 * np.prod(nf))
    first = [rng.integers(0, n, m) for n in nf]
    if seed == 2:  # crowd a few bins past SUBPROBLEM targets
        first = [np.where(rng.uniform(size=m) < 0.5, f % edge, f) for f in first]
    perm, off = interp_mod.bin_order_3d(_tables(first, nf, w), nf, itemsize, select=False)
    keys = _brute_keys(first, nf, edge)
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))
    assert off[0] == 0 and off[-1] == m and np.all(np.diff(off) >= 1)
    assert np.diff(off).max() <= interp_mod.SUBPROBLEM
    ks = keys[perm]
    for a, b in zip(off[:-1], off[1:]):
        assert ks[a] == ks[b - 1]  # a piece lies in one bin
    # Every bin starts a piece.
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    assert set(starts) <= set(off[:-1])
    # The table's rule: the largest edge up to 8 whose tile fits.
    assert (edge + w - 1) ** 3 * 2 * itemsize <= interp_mod.TILE_BYTES
    assert edge == interp_mod.MAX_BIN_EDGE or (
        (edge + w) ** 3 * 2 * itemsize > interp_mod.TILE_BYTES)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("w", list(range(2, 17)))
def test_bin_edge_table_is_the_rule(w, itemsize):
    """The edges the host planner reads from csrc/bins.cuh are the rule
    the header states (and its static_assert holds on the card): the
    largest edge up to kMaxEdge whose padded tile fits kTileBytes."""
    assert (interp_mod.TILE_BYTES, interp_mod.MAX_BIN_EDGE) == (112 * 1024, 8)
    want = max(b for b in range(1, interp_mod.MAX_BIN_EDGE + 1)
               if (b + w - 1) ** 3 * 2 * itemsize <= interp_mod.TILE_BYTES)
    assert interp_mod.bin_edge_3d(w, itemsize) == want


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("w", [4, 14])
def test_bin_order_declines_a_short_axis(axis, w):
    edge = interp_mod.bin_edge_3d(w, 8)
    nf = [edge + w + 5] * 3
    nf[axis] = edge + w - 2  # one cell short of the padded tile
    rng = np.random.default_rng(axis)
    m = int(np.prod(nf))
    first = [rng.integers(0, n, m) for n in nf]
    assert interp_mod.bin_order_3d(_tables(first, nf, w), nf, 8) is None
    nf[axis] += 1
    first = [rng.integers(0, n, m) for n in nf]
    assert interp_mod.bin_order_3d(_tables(first, nf, w), nf, 8) is not None


def test_bin_order_declines_low_density_and_foreign_tables():
    rng = np.random.default_rng(4)
    nf, w = (40, 40, 40), 6
    edge = interp_mod.bin_edge_3d(w, 8)
    nbins = int(np.prod([-(-n // edge) for n in nf]))
    t_min = interp_mod.SM_MIN_TARGETS_PER_BIN[8][0]
    few, plenty = t_min - 1, t_min + 1
    # Every bin holds `few` (then `plenty`) targets.
    bins = np.stack(np.meshgrid(*[np.arange(-(-n // edge)) for n in nf], indexing="ij"), -1)
    bins = bins.reshape(-1, 3)
    for per_bin, planned in ((int(few), False), (int(np.ceil(plenty)), True)):
        pick = np.repeat(bins, per_bin, axis=0)
        first = [np.minimum(pick[:, a] * edge + rng.integers(0, edge, len(pick)), nf[a] - 1)
                 for a in range(3)]
        got = interp_mod.bin_order_3d(_tables(first, nf, w), nf, 8)
        assert (got is not None) == planned
        assert interp_mod.bin_order_3d(_tables(first, nf, w), nf, 8, select=False) is not None
    assert len(pick) == nbins * per_bin
    tabs = _tables([rng.integers(0, n, len(pick)) for n in nf], nf, w)
    tabs[1] = tabs[1][:, ::-1].copy()  # not consecutive from the first cell
    assert interp_mod.bin_order_3d(tabs, nf, 8) is None


@pytest.mark.parametrize("itemsize", [4, 8])
def test_bin_order_declines_a_small_region(itemsize):
    """Dense targets clustered into a few bins (the cells a gather reads
    stay in cache): no order, though every bin is crowded."""
    rng = np.random.default_rng(5)
    nf, w = (64, 64, 32), 8
    edge = interp_mod.bin_edge_3d(w, itemsize)
    cells = interp_mod.SM_MIN_REGION_BYTES[itemsize] // (2 * itemsize * edge**3)
    m = 20_000
    first = [rng.integers(0, edge, m), rng.integers(0, edge, m), rng.integers(0, edge, m)]
    assert cells >= 1  # one bin holds fewer cells than the threshold
    assert interp_mod.bin_order_3d(_tables(first, nf, w), nf, itemsize) is None
    spread_out = [rng.integers(0, n, m) for n in nf]
    got = interp_mod.bin_order_3d(_tables(spread_out, nf, w), nf, itemsize, select=False)
    assert got is not None


@pytest.mark.parametrize("itemsize", [4, 8])
def test_sm_choice_reads_region_and_cache_level(itemsize):
    """``_sm_pays`` at its thresholds: the region of the nonempty bins
    against SM_MIN_REGION_BYTES, and the targets a bin against the L2 and
    past-L2 entries of SM_MIN_TARGETS_PER_BIN."""
    edge = 8
    cell = 2 * itemsize * edge**3  # bytes of one bin
    t_l2, t_far = interp_mod.SM_MIN_TARGETS_PER_BIN[itemsize]
    small = interp_mod.SM_MIN_REGION_BYTES[itemsize] // cell - 1
    assert not interp_mod._sm_pays(10**6 * small, small, edge, itemsize)
    in_l2 = interp_mod.L2_BYTES // cell - 1
    far = interp_mod.L2_BYTES // cell + 1
    assert in_l2 * cell >= interp_mod.SM_MIN_REGION_BYTES[itemsize]
    assert interp_mod._sm_pays(int(np.ceil(t_l2 * in_l2)), in_l2, edge, itemsize)
    assert not interp_mod._sm_pays(int(np.ceil(t_l2 * in_l2)) - 1, in_l2, edge, itemsize)
    assert interp_mod._sm_pays(int(np.ceil(t_far * far)), far, edge, itemsize)
    assert not interp_mod._sm_pays(int(np.ceil(t_far * far)) - 1, far, edge, itemsize)


# ------------------------------------------------ the sort of the spread

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("w", [3, 8, 14])
def test_bin_sort_matches_brute_force(w, dtype):
    rng = np.random.default_rng(w)
    nf, edge, n = (30, 26, 20), 6, 3000
    u = [rng.uniform(-n_ / 2, n_, n) for n_ in nf]
    u[0][:3] = (nf[0], 0.0, -nf[0] / 2)  # on the wrap and negative
    ut = [torch.tensor(a, dtype=dtype) for a in u]
    perm, off = spread_mod.bin_sort_3d(ut, nf, w, edge)
    # NumPy in the same dtype: the first tap cell ceil(u - w/2) mod n.
    npd = np.float32 if dtype == torch.float32 else np.float64
    first = [np.mod(np.ceil(a.astype(npd) - npd(w / 2)).astype(np.int64), n_)
             for a, n_ in zip(u, nf)]
    keys = _brute_keys(first, nf, edge)
    np.testing.assert_array_equal(spread_mod.bin_keys_3d(ut, nf, w, edge).numpy(), keys)
    np.testing.assert_array_equal(perm.numpy(), np.argsort(keys, kind="stable"))
    nbins = int(np.prod([-(-n_ // edge) for n_ in nf]))
    np.testing.assert_array_equal(off.numpy(), np.searchsorted(np.sort(keys),
                                                               np.arange(nbins + 1)))


@pytest.mark.parametrize("d_case", ["uniform", "clustered"])
def test_spread_in_bin_order_equals_unsorted(d_case):
    rng = np.random.default_rng(7)
    nf, w, n, C = (24, 20, 18), 7, 1500, 2
    u = [rng.uniform(0, m, n) for m in nf]
    if d_case == "clustered":
        u = [np.mod(rng.uniform(0, m, 3)[rng.integers(0, 3, n)] + rng.uniform(0, 2, n), m)
             for m in nf]
    wts = rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
    ut = [torch.tensor(a) for a in u]
    wt = torch.tensor(wts)
    perm, _ = spread_mod.bin_sort_3d(ut, nf, w, 4)
    beta = 2.3 * w
    want = spread_mod.spread_nd_plain(ut, wt, torch.zeros((C,) + nf, dtype=wt.dtype), w, beta)
    got = spread_mod.spread_nd_plain([a[perm] for a in ut], wt[:, perm],
                                     torch.zeros_like(want), w, beta)
    assert _rel(got.numpy(), want.numpy()) <= 1e-13


# ------------------------------------------ the executors against fftvis_tpu

def _type3_problem(seed=3):
    # 4000 targets on a (32, 32, 32) grid: 0.12 a cell, above the density
    # threshold of the bin order.
    rng = np.random.default_rng(seed)
    s = rng.uniform(-10, 10, (3, 4000))
    return s, 0.2


def test_type3_interpolation_in_bin_order_matches_jax():
    s, extent = _type3_problem()
    plan = plan_type3(s, extent, 1e-9)
    ex = Type3Executor(plan, device="cpu")
    _, _, order, runs = ex._taps(torch.float64)
    assert order is not None and runs is not None  # the d = 3 bin order
    G = np.random.default_rng(1).normal(size=(2,) + plan.nf) + 0j
    got = ex.interpolate(torch.tensor(G)).numpy()
    want = jax_transform.Type3Executor(jnufft.plan_type3(s, extent, 1e-9)).interpolate(
        jnp.asarray(G))
    assert _rel(got, want) <= 1e-13


@pytest.mark.parametrize("point_block", [None, 7000])
def test_type2_interpolation_in_bin_order_matches_jax(point_block):
    # 20000 points on a (48, 48, 48) grid, 0.18 a cell (7000 a block: 0.06).
    rng = np.random.default_rng(5)
    modes = rng.integers(-8, 9, (3, 60))
    x = rng.uniform(-np.pi, np.pi, (3, 20000))
    f = rng.normal(size=(2, 60)) + 1j * rng.normal(size=(2, 60))
    ex = Type2Executor(plan_type2(x, modes, 1e-9), device="cpu")
    g = ex.transform(ex.scatter(torch.tensor(f)))
    got = ex.interp(g, point_block=point_block).numpy()
    assert ex._taps(torch.float64, 0, point_block or 20000)[2] is not None
    want = jnufft.make_type2_fn(jnufft.plan_type2(x, modes, 1e-9))(jnp.asarray(f))
    assert _rel(got, want) <= 1e-12


def test_interp_nd_with_order_matches_plain():
    rng = np.random.default_rng(9)
    nf, w, m = (30, 28, 26), 6, 9000
    first = [rng.integers(0, n, m) for n in nf]
    idx = _tables(first, nf, w)
    u = [f + rng.uniform(0, 1, m) + w / 2 for f in first]
    val = [es_kernel_grid(ua[:, None] - (f[:, None] + np.arange(w)), w, 2.3 * w)
           for ua, f in zip(u, first)]
    perm, off = interp_mod.bin_order_3d(idx, nf, 8)
    G = torch.tensor(rng.normal(size=(3,) + nf) + 1j * rng.normal(size=(3,) + nf))
    want = interp_mod.interp_nd_plain(G, [torch.tensor(a) for a in idx],
                                      [torch.tensor(a) for a in val])
    got = interp_mod.interp_nd(G, [torch.tensor(a[perm]) for a in idx],
                               [torch.tensor(a[perm]) for a in val],
                               torch.tensor(perm), torch.tensor(off))
    assert _rel(got.numpy(), want.numpy()) <= 1e-14


# ------------------------------------------------ the wrappers' checks

def _nd_inputs():
    idx = [torch.zeros((5, 4), dtype=torch.int32) for _ in range(3)]
    val = [torch.ones((5, 4), dtype=torch.float64) for _ in range(3)]
    return torch.zeros((2, 8, 8, 8), dtype=torch.complex128), idx, val


@pytest.mark.parametrize("fault,exc", [
    ("index dtype", TypeError), ("value dtype", TypeError), ("grid dtype", TypeError),
    ("table shape", ValueError), ("width", ValueError), ("order without runs", ValueError),
    ("order dtype", TypeError), ("order length", ValueError), ("tables a grid's d", ValueError),
])
def test_interp_nd_checks_raise(fault, exc):
    G, idx, val = _nd_inputs()
    order = runs = None
    if fault == "index dtype":
        idx[1] = idx[1].long()
    elif fault == "value dtype":
        val[2] = val[2].float()
    elif fault == "grid dtype":
        G = G.real
    elif fault == "table shape":
        val[0] = torch.ones((6, 4), dtype=torch.float64)
    elif fault == "width":
        idx = [torch.zeros((5, 17), dtype=torch.int32) for _ in range(3)]
        val = [torch.ones((5, 17), dtype=torch.float64) for _ in range(3)]
    elif fault == "order without runs":
        order = torch.arange(5, dtype=torch.int32)
    elif fault == "order dtype":
        order, runs = torch.arange(5), torch.tensor([0, 5], dtype=torch.int32)
    elif fault == "order length":
        order, runs = (torch.arange(4, dtype=torch.int32),
                       torch.tensor([0, 5], dtype=torch.int32))
    else:
        G = G[0]
    with pytest.raises(exc):
        interp_mod.interp_nd(G, idx, val, order, runs)


@pytest.mark.parametrize("fault,exc", [
    ("coordinate dtype", TypeError), ("coordinate length", ValueError),
    ("weight dtype", TypeError), ("weight shape", ValueError), ("channels", ValueError),
    ("width", ValueError), ("grid d", ValueError), ("grid layout", ValueError),
])
def test_spread_nd_checks_raise(fault, exc):
    u = [torch.zeros(5, dtype=torch.float64) for _ in range(3)]
    wts = torch.zeros((2, 5), dtype=torch.complex128)
    grid = torch.zeros((2, 8, 8, 8), dtype=torch.complex128)
    w = 4
    if fault == "coordinate dtype":
        u[2] = u[2].float()
    elif fault == "coordinate length":
        u[1] = torch.zeros(6, dtype=torch.float64)
    elif fault == "weight dtype":
        wts = wts.to(torch.complex64)
    elif fault == "weight shape":
        wts = torch.zeros((2, 6), dtype=torch.complex128)
    elif fault == "channels":
        grid = torch.zeros((3, 8, 8, 8), dtype=torch.complex128)
    elif fault == "width":
        w = 17
    elif fault == "grid d":
        grid = grid[0]
    else:
        grid = grid.transpose(1, 3)
    with pytest.raises(exc):
        spread_mod.spread_nd(u, wts, grid, w, 2.3 * w)
