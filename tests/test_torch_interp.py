"""The port's tap interpolation vs the JAX package's interpolations.

On the CPU the port's ``interp`` runs its plain torch version. The same
plan (its tap tables) and the same grid go to both sides:

- float32, against ``PallasInterp(plan)(G)`` in interpret mode at the sizes
  of ``tests/test_pallas_interp.py``; atol 2e-5 * scale (float32 sums in
  two orders);
- float64, against the JAX executor's einsum gather at 1e-12 * scale;
- the target order (a tile-sorted permutation of the targets) through
  which the executor keeps its tap tables changes nothing: 1e-5 / 1e-12 of
  scale against the unpermuted tables (rounding of the einsum only);
- the footprint runs the kernel takes (maximal runs of identical tap
  cells, cut at a cap) and the wrapper's refusal of bad ones.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fftvis_tpu.nufft.pallas_interp import PallasInterp
from fftvis_tpu.nufft.transform import Type3Executor as JaxExecutor
from fftvis_tpu.nufft.transform import plan_type3
from fftvis_tpu_torch.nufft.interp import footprint_runs, interp, interp_plain, target_order
from fftvis_tpu_torch.nufft.transform import Type3Executor, Type3Plan


def _plan_and_grid(m, nf_hint, seed, C=1):
    """A type-3 plan with ~nf_hint fine grid and m clustered targets."""
    rng = np.random.default_rng(seed)
    S = nf_hint / 16.0
    s = np.concatenate(
        [rng.normal(0, S / 10, (2, m // 2)),
         rng.uniform(-S, S, (2, m - m // 2))],
        axis=1,
    )
    plan = plan_type3(s, x_extent=2 * np.pi, eps=1e-6, upsample_factor=2.0)
    G = rng.normal(size=(C,) + tuple(plan.nf)) + 1j * rng.normal(size=(C,) + tuple(plan.nf))
    return plan, G


def _port(plan, G, rdt, cdt):
    p = Type3Plan.from_reference(plan)
    iy, ix = (torch.tensor(a, dtype=torch.int32) for a in p.tap_idx)
    vy, vx = (torch.tensor(a, dtype=rdt) for a in p.tap_val)
    return interp(torch.tensor(G, dtype=cdt), iy, ix, vy, vx).numpy()


@pytest.mark.parametrize("m,C", [(300, 1), (700, 2)])
def test_interp_matches_pallas(m, C):
    plan, G = _plan_and_grid(m, 400, seed=m, C=C)
    G = G.astype(np.complex64)
    want = np.asarray(PallasInterp(plan)(jnp.asarray(G)))
    got = _port(plan, G, torch.float32, torch.complex64)
    scale = np.abs(want).max()
    assert got.shape == want.shape == (C, m)
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=0)


@pytest.mark.parametrize("m,C", [(300, 1), (700, 2)])
def test_interp_matches_einsum_f64(m, C):
    plan, G = _plan_and_grid(m, 400, seed=m + 1, C=C)
    want = np.asarray(JaxExecutor(plan).interpolate(jnp.asarray(G)))
    assert want.dtype == np.complex128
    got = _port(plan, G, torch.float64, torch.complex128)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-12 * scale, rtol=0)


def _tables(plan, rdt, order=None):
    p = Type3Plan.from_reference(plan)
    rows = slice(None) if order is None else order
    iy, ix = (torch.tensor(a[rows], dtype=torch.int32) for a in p.tap_idx)
    vy, vx = (torch.tensor(a[rows], dtype=rdt) for a in p.tap_val)
    return iy, ix, vy, vx


@pytest.mark.parametrize("m,tile", [(300, 32), (700, 32), (700, 8)])
def test_target_order_is_a_tile_sorted_permutation(m, tile):
    plan, _ = _plan_and_grid(m, 400, seed=m + 2)
    iy0, ix0 = (a[:, 0] for a in plan.tap_idx)
    order = target_order(iy0, ix0, tile)
    assert order.dtype == np.int32
    assert np.array_equal(np.sort(order), np.arange(m))
    ty, tx = iy0[order] // tile, ix0[order] // tile
    key = ty.astype(np.int64) * (int(tx.max()) + 1) + tx
    assert np.all(np.diff(key) >= 0)
    # Identical first taps (redundant baselines) sit next to each other.
    cells = list(zip(iy0[order], ix0[order]))
    runs = sum(1 for a, b in zip(cells, cells[1:]) if a != b) + 1
    assert runs == len(set(cells))


@pytest.mark.parametrize("rdt,cdt,tol", [(torch.float32, torch.complex64, 1e-5),
                                         (torch.float64, torch.complex128, 1e-12)])
def test_interp_through_target_order(rdt, cdt, tol):
    """The permuted tables, scattered back through ``order``, give the
    unpermuted result, and still match the JAX package."""
    m, C = 700, 2
    plan, G = _plan_and_grid(m, 400, seed=11, C=C)
    Gt = torch.tensor(G, dtype=cdt)
    want = interp_plain(Gt, *_tables(plan, rdt)).numpy()
    order = target_order(plan.tap_idx[0][:, 0], plan.tap_idx[1][:, 0])
    tabs = _tables(plan, rdt, order)
    scattered = np.empty_like(want)
    scattered[:, order] = interp_plain(Gt, *tabs).numpy()
    got = interp(Gt, *tabs, order=torch.tensor(order)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(scattered, want, atol=tol * scale, rtol=0)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)
    # Through the executor, whose tables are in target order.
    ex_got = Type3Executor(Type3Plan.from_reference(plan), device="cpu").interpolate(Gt).numpy()
    np.testing.assert_allclose(ex_got, want, atol=tol * scale, rtol=0)
    if rdt == torch.float32:
        ref = np.asarray(PallasInterp(plan)(jnp.asarray(G.astype(np.complex64))))
        np.testing.assert_allclose(got, ref, atol=2e-5 * scale, rtol=0)
    else:
        ref = np.asarray(JaxExecutor(plan).interpolate(jnp.asarray(G)))
        np.testing.assert_allclose(got, ref, atol=tol * scale, rtol=0)


@pytest.mark.parametrize("w", [1, 17])
def test_interp_width_outside_range_raises(w):
    G = torch.zeros((1, 40, 40), dtype=torch.complex64)
    iy = torch.zeros((5, w), dtype=torch.int32)
    vy = torch.ones((5, w), dtype=torch.float32)
    with pytest.raises(ValueError, match="kernel width"):
        interp(G, iy, iy.clone(), vy, vy.clone())


@pytest.mark.parametrize("case", ["dtype", "shape", "runs", "runs shape"])
def test_interp_refuses_a_bad_order(case):
    G = torch.zeros((1, 16, 16), dtype=torch.complex64)
    iy = torch.zeros((5, 4), dtype=torch.int32)
    vy = torch.ones((5, 4), dtype=torch.float32)
    order = torch.arange(5, dtype=torch.int64 if case == "dtype" else torch.int32)
    runs = torch.tensor([0, 5], dtype=torch.int64 if case == "runs" else torch.int32)
    if case == "runs shape":
        runs = torch.tensor([5], dtype=torch.int32)  # no run for five rows
    if case == "shape":
        order = order[:4]
    with pytest.raises((TypeError, ValueError)):
        interp(G, iy, iy.clone(), vy, vy.clone(), order=order, runs=runs)


@pytest.mark.parametrize("cap", [1, 3, 32])
@pytest.mark.parametrize("w", [2, 8])
def test_footprint_runs_are_maximal_identical_rows(cap, w):
    """Runs of identical tap cells in the sorted tables: they cover every
    row in order, hold at most ``cap`` rows of one footprint each, and end
    only where the footprint changes or the run is full."""
    rng = np.random.default_rng(cap + w)
    m = 900
    pick = rng.integers(0, 50, m)
    iy, ix = rng.integers(0, 60, (50, w))[pick], rng.integers(0, 60, (50, w))[pick]
    alt = rng.random(m) < 0.2  # the same first cell, another last column
    ix[alt, w - 1] = (ix[alt, w - 1] + 1) % 60
    order = target_order(iy[:, 0], ix[:, 0])
    iy, ix = iy[order], ix[order]
    runs = footprint_runs(iy, ix, cap)
    assert runs.dtype == np.int32 and runs[0] == 0 and runs[-1] == m
    lens = np.diff(runs)
    assert np.all(lens >= 1) and np.all(lens <= cap)
    for a, b in zip(runs[:-1], runs[1:]):
        assert np.all(iy[a:b] == iy[a]) and np.all(ix[a:b] == ix[a])
        if b < m and b - a < cap:
            assert np.any(iy[b] != iy[b - 1]) or np.any(ix[b] != ix[b - 1])
    if cap == 32:
        assert lens.max() > 3  # long runs exist to take the shared form


def test_footprint_runs_of_the_executor():
    """The executor keeps the target order and the runs of its
    tile-ordered tables beside them."""
    plan, _ = _plan_and_grid(300, 400, seed=4)
    ex = Type3Executor(Type3Plan.from_reference(plan), device="cpu")
    (iy, ix), _, order, runs = ex._taps(torch.float64)
    assert np.array_equal(order.numpy(), target_order(plan.tap_idx[0][:, 0],
                                                      plan.tap_idx[1][:, 0]))
    assert np.array_equal(runs.numpy(), footprint_runs(iy.numpy(), ix.numpy()))
