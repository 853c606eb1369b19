"""The owned-tile adjoint of the type-3 interpolation, and the one autograd
node that interpolates every beam pair's channels of one grid.

- ``interp.grid_tiles`` (the plan-time lists of ``interp_adjoint_tiles``)
  against a brute force: every run is listed in every 32 x 32 (or 8 x 8)
  tile its w x w footprint touches, periodic wrap included, each of its
  cells once, and nowhere else; the staged-cell offsets are the running sum
  of the rectangles. Plan tables (w consecutive cells mod nf) and arbitrary
  tables (repeated and scattered cells) both.
- A NumPy emulation of the kernel's owned-tile sum (each tile's list in
  order, each rectangle's cells summed over the run's rows, then added to
  the cells it lands on) against ``interp_adjoint_plain`` (1e-13, float64).
- ``interp_pairs``' gradient (``InterpPairsFunction``) against the
  autograd of ``interp_plain`` on each channel slice (1e-12 / 1e-5 of
  max|gradient|, float64 / float32); its checks.
- The executors' interpolation gradient against ``jax.vjp`` of
  ``fftvis_tpu``'s ``Type3Executor.interpolate`` on the same ``plan_type3``
  inputs (1e-12 / 1e-5), for every target and for several pairs' subsets
  through ``interpolate_pairs``; the executor's tile lists, built from its
  own tables, driving the owned-tile sum to ``jax.vjp``'s gradient; the
  low-rank-z executor's pairs against its single-pair interpolation.
- A multi-pair (per-antenna, forced type-3) gradient of the loss on
  ``device="cpu"`` against ``jax.grad`` of the JAX package's, and its graph:
  one interpolation node a (time, frequency), no slice of the grid.

On a CUDA card (marked ``cuda``; skipped without one): both adjoint kernels
repeat bitwise, and one multi-pair backward fills and adds no tensor of
the grid's size.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fftvis_tpu
from fftvis_tpu import nufft as jnufft
from fftvis_tpu.beams import GaussianBeam as JGaussianBeam
from fftvis_tpu.beams.gridded import GriddedBeam as JGriddedBeam
from fftvis_tpu.nufft import transform as jax_transform
from fftvis_tpu_torch import build_differentiable_sim
from fftvis_tpu_torch.autodiff import params_from_reference
from fftvis_tpu_torch.beams import GaussianBeam
from fftvis_tpu_torch.beams import eval as eval_mod
from fftvis_tpu_torch.beams.gridded import GriddedBeam
from fftvis_tpu_torch.coords import TelescopeLocation
from fftvis_tpu_torch.nufft import interp as interp_mod
from fftvis_tpu_torch.nufft.transform import (
    Type3Executor,
    Type3LowrankZExecutor,
    plan_type3,
    plan_type3_lowrank_z,
)

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
CDT = {torch.float32: torch.complex64, torch.float64: torch.complex128}
LOC = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JLOC = fftvis_tpu.TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _crandn(rng, shape, dtype=torch.complex128):
    return torch.tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape), dtype=dtype)


def _tables(seed, m, nf, w, kind):
    """Host (m, w) tap tables in visiting order and their runs: ``plan``
    tables of w consecutive cells (mod nf) with half the targets on one
    footprint, footprints on the wrap, or ``arbitrary`` cells."""
    rng = np.random.default_rng(seed)
    i0 = np.stack([rng.integers(0, nf[0], m), rng.integers(0, nf[1], m)])
    i0[:, m // 2:] = i0[:, :1]
    i0[:, 1:4] = [[nf[0] - 1, nf[0] - w // 2, 0], [nf[1] - 2, 0, nf[1] - w + 1]]
    iy = (i0[0][:, None] + np.arange(w)) % nf[0]
    ix = (i0[1][:, None] + np.arange(w)) % nf[1]
    if kind == "arbitrary":
        iy = rng.integers(0, nf[0], (m, w))
        ix = rng.integers(0, nf[1], (m, w))
        iy[:, 1] = iy[:, 0]  # a repeated cell in a row
    vy, vx = rng.uniform(0.1, 1, (m, w)), rng.uniform(0.1, 1, (m, w))
    order = interp_mod.target_order(iy[:, 0], ix[:, 0])
    iy, ix, vy, vx = iy[order], ix[order], vy[order], vx[order]
    return rng, order, iy, ix, vy, vx, interp_mod.footprint_runs(iy, ix)


def _unpack(geom):
    return (geom & 31, (geom >> 5) & 31, (geom >> 10) & 15, ((geom >> 14) & 15) + 1,
            (geom >> 18) & 15, ((geom >> 22) & 15) + 1)


# ------------------------------------------------------ the plan-time lists

@pytest.mark.parametrize("kind", ["plan", "arbitrary"])
@pytest.mark.parametrize("tile", [32, 8])
@pytest.mark.parametrize("seed,m,nf,w", [(0, 200, (70, 45), 8), (1, 60, (33, 65), 14),
                                         (2, 300, (96, 96), 16), (3, 40, (20, 17), 7)])
def test_grid_tiles_list_every_touched_tile(seed, m, nf, w, tile, kind):
    _, _, iy, ix, _, _, runs = _tables(seed, m, nf, w, kind)
    off, ent = interp_mod.grid_tiles(iy, ix, runs, nf, tile)
    ntx = -(-nf[1] // tile)
    assert off.shape == (-(-nf[0] // tile) * ntx + 1,) and off[-1] == len(ent)
    want, got = {}, {}
    for r in range(len(runs) - 1):
        k0, k1 = runs[r], runs[r + 1]
        for a in range(w):
            for b in range(w):
                y, x = iy[k0, a], ix[k0, b]
                want.setdefault((y // tile) * ntx + x // tile, []).append(
                    (k0, k1, a, b, y % tile, x % tile))
    for t in range(len(off) - 1):
        for k0, k1, geom, _ in ent[off[t]:off[t + 1]]:
            ly0, lx0, a0, na, b0, nb = _unpack(geom)
            assert ly0 + na <= tile and lx0 + nb <= tile
            got.setdefault(t, []).extend((k0, k1, a0 + i, b0 + j, ly0 + i, lx0 + j)
                                         for i in range(na) for j in range(nb))
    assert {t: sorted(v) for t, v in got.items()} == {t: sorted(v) for t, v in want.items()}
    sizes = [na * nb for _, _, _, na, _, nb in map(_unpack, ent[:, 2])]
    np.testing.assert_array_equal(ent[:, 3], np.cumsum(sizes) - sizes)


def test_grid_tiles_keep_run_order_within_a_tile():
    """A tile's entries come in the runs' visiting order: the order the
    kernel's sums follow."""
    _, _, iy, ix, _, _, runs = _tables(4, 500, (64, 64), 8, "plan")
    off, ent = interp_mod.grid_tiles(iy, ix, runs, (64, 64))
    for t in range(len(off) - 1):
        k0 = ent[off[t]:off[t + 1], 0]
        assert np.all(np.diff(k0) >= 0)


def _owned_tile_sum(g, vy, vx, order, off, ent, nf, tile=interp_mod.TILE):
    """NumPy emulation of interp_adjoint_tiles: each tile's entries in list
    order, each rectangle's cells summed over its run's rows for every
    channel, then added to the tile cells they land on; every cell of the
    grid written once."""
    C = g.shape[0]
    ntx = -(-nf[1] // tile)
    out = np.full((C,) + tuple(nf), np.nan, dtype=g.dtype)
    for t in range(len(off) - 1):
        y0, x0 = t // ntx * tile, t % ntx * tile
        acc = np.zeros((C, tile, tile), dtype=g.dtype)
        for k0, k1, geom, _ in ent[off[t]:off[t + 1]]:
            ly0, lx0, a0, na, b0, nb = _unpack(geom)
            rows = np.arange(k0, k1)
            wts = vy[rows][:, a0:a0 + na, None] * vx[rows][:, None, b0:b0 + nb]
            staged = np.einsum("kab,ck->cab", wts, g[:, order[rows]])
            acc[:, ly0:ly0 + na, lx0:lx0 + nb] += staged
        ys, xs = slice(y0, min(y0 + tile, nf[0])), slice(x0, min(x0 + tile, nf[1]))
        out[:, ys, xs] = acc[:, :ys.stop - y0, :xs.stop - x0]
    return out


@pytest.mark.parametrize("kind", ["plan", "arbitrary"])
@pytest.mark.parametrize("seed,m,nf,w,C", [(5, 400, (70, 45), 8, 3), (6, 150, (64, 96), 14, 1),
                                           (7, 90, (40, 33), 16, 4)])
def test_owned_tile_sum_matches_plain(seed, m, nf, w, C, kind):
    rng, order, iy, ix, vy, vx, runs = _tables(seed, m, nf, w, kind)
    g = rng.normal(size=(C, m)) + 1j * rng.normal(size=(C, m))
    off, ent = interp_mod.grid_tiles(iy, ix, runs, nf)
    got = _owned_tile_sum(g, vy, vx, order, off, ent, nf)
    # The plain adjoint on the tables' rows: row k is target order[k].
    want = interp_mod.interp_adjoint_plain(
        torch.tensor(g[:, order]), *(torch.tensor(a) for a in (iy.astype(np.int32),
                                                               ix.astype(np.int32), vy, vx)),
        *nf).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, want) <= 1e-13


def test_interp_adjoint_tiles_kernel_owns_its_output():
    """The kernel adds into the grid with no atomic: every cell is written
    once, by its owner thread."""
    src = (Path(interp_mod.__file__).resolve().parent.parent / "csrc" / "interp.cu").read_text()
    start = re.search(r"__global__ void __launch_bounds__\(.*\) interp_adjoint_tiles\(",
                      src).start()
    body = src[start:src.index("\n}\n", start)]
    assert "atomic" not in body


# ------------------------------------------------- one node for all pairs

def _pair_tables(seed, nf, w, sizes, dtype):
    """Device (CPU) tables of several pairs, as interp_pairs takes them."""
    out = []
    for p, m in enumerate(sizes):
        _, order, iy, ix, vy, vx, runs = _tables(seed + p, m, nf, w, "plan")
        out.append(([torch.tensor(a, dtype=torch.int32) for a in (iy, ix)]
                    + [torch.tensor(a, dtype=dtype) for a in (vy, vx)],
                    torch.tensor(order, dtype=torch.int32), torch.tensor(runs, dtype=torch.int32),
                    np.argsort(order)))
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_interp_pairs_gradient_matches_per_slice_autograd(dtype):
    rng = np.random.default_rng(8)
    nf, w, cp, sizes = (40, 36), 6, 4, (50, 17, 33)
    tabs = _pair_tables(20, nf, w, sizes, dtype)
    G = _crandn(rng, (cp * len(sizes),) + nf, CDT[dtype]).requires_grad_()
    gs = [_crandn(rng, (cp, m), CDT[dtype]) for m in sizes]
    pairs = [(p * cp, (p + 1) * cp, (*t, o, r, None)) for p, (t, o, r, _) in enumerate(tabs)]
    outs = interp_mod.interp_pairs(G, pairs)
    assert outs[0].grad_fn.__class__.__name__ == "InterpPairsFunctionBackward"
    (got,) = torch.autograd.grad(outs, G, gs)
    loss = 0
    for p, ((iy, ix, vy, vx), _, _, inv) in enumerate(tabs):
        # interp_plain of the tables in target order, on the slice.
        plain = [a[torch.as_tensor(inv)] for a in (iy, ix, vy, vx)]
        out = interp_mod.interp_plain(G[p * cp:(p + 1) * cp], *plain)
        loss = loss + (torch.conj(gs[p]) * out).real.sum()
    (want,) = torch.autograd.grad(loss, G)
    assert _rel(got, want) <= TOL[dtype]
    for p, ((iy, ix, vy, vx), o, r, inv) in enumerate(tabs):
        single = interp_mod.interp(G.detach()[p * cp:(p + 1) * cp], iy, ix, vy, vx, o, r)
        assert torch.equal(outs[p].detach(), single)


def test_interp_pairs_leaves_unread_channels_zero_and_checks_slices():
    rng = np.random.default_rng(9)
    nf, w = (24, 20), 4
    (t, o, r, _), = _pair_tables(30, nf, w, (15,), torch.float64)
    G = _crandn(rng, (6,) + nf).requires_grad_()
    (out,) = interp_mod.interp_pairs(G, [(2, 4, (*t, o, r, None))])
    (got,) = torch.autograd.grad(out, G, _crandn(rng, out.shape))
    assert (got[:2] == 0).all() and (got[4:] == 0).all() and got[2:4].abs().max() > 0
    for bad in ([(0, 3, (*t, o, r, None)), (2, 4, (*t, o, r, None))],
                [(4, 7, (*t, o, r, None))], [(3, 2, (*t, o, r, None))]):
        with pytest.raises(ValueError, match="disjoint"):
            interp_mod.interp_pairs(G, bad)


def test_interp_adjoint_writes_into_out():
    rng = np.random.default_rng(10)
    nf = (24, 20)
    (t, o, r, _), = _pair_tables(40, nf, 5, (31,), torch.float64)
    g = _crandn(rng, (2, 31))
    big = torch.full((5,) + nf, complex("nan"), dtype=torch.complex128)
    got = interp_mod.interp_adjoint(g, *t, nf, order=o, runs=r, out=big[1:3])
    assert got.data_ptr() == big[1:3].data_ptr()
    assert torch.equal(big[1:3], interp_mod.interp_adjoint(g, *t, nf, order=o, runs=r))
    with pytest.raises(ValueError, match="out must be"):
        interp_mod.interp_adjoint(g, *t, nf, order=o, runs=r, out=big[1:4])


# ------------------------------------------- the executors against JAX

def _targets(seed, m=700):
    """2D targets with repeats, as a redundant array's baselines give them."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-40, 40, (2, m // 3))
    return np.concatenate([base, base[:, : m // 3], rng.uniform(-40, 40, (2, m - 2 * (m // 3)))],
                          axis=1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_executor_interp_gradient_matches_jax_vjp(dtype):
    s = _targets(11)
    extent = 0.3
    plan, jplan = plan_type3(s, extent, 1e-9), jnufft.plan_type3(s, extent, 1e-9)
    ex, jex = Type3Executor(plan, device="cpu"), jax_transform.Type3Executor(jplan)
    rng = np.random.default_rng(12)
    m = s.shape[1]
    sels = [None, np.arange(0, m, 3), np.arange(m // 2), np.arange(m // 2, m)]
    cp = 2
    npc = np.complex64 if dtype == torch.float32 else np.complex128
    G = (rng.normal(size=(cp * len(sels),) + plan.nf)
         + 1j * rng.normal(size=(cp * len(sels),) + plan.nf)).astype(npc)
    gs = [(rng.normal(size=(cp, m if s_ is None else len(s_)))
           + 1j * rng.normal(size=(cp, m if s_ is None else len(s_)))).astype(npc) for s_ in sels]
    Gt = torch.tensor(G).requires_grad_()
    outs = ex.interpolate_pairs(Gt, sels)
    (got,) = torch.autograd.grad(outs, Gt, [torch.tensor(g) for g in gs])
    want = np.zeros_like(G)
    for p, sel in enumerate(sels):
        jout, vjp = jax.vjp(lambda x, sel=sel: jex.interpolate(x, sel),
                            jnp.asarray(G[p * cp:(p + 1) * cp]))
        want[p * cp:(p + 1) * cp] = np.asarray(vjp(jnp.asarray(gs[p]))[0])
        assert _rel(outs[p].detach().numpy(), jout) <= TOL[dtype]
    assert _rel(got.numpy(), want) <= TOL[dtype]
    # The single-pair entry is the same node with one pair.
    (one,) = torch.autograd.grad(ex.interpolate(Gt[:cp], sels[1]), Gt, torch.tensor(gs[1]))
    assert _rel(one[:cp].numpy(), want[cp:2 * cp]) <= TOL[dtype]


@pytest.mark.parametrize("part", ["all", "every third", "second half"])
def test_executor_tiles_follow_its_tables(part):
    """The executor's tile lists (``_tiles``), made from the very tables and
    runs that ``_taps`` gives the kernels, drive the owned-tile sum on those
    tables to the gradient ``jax.vjp`` gives for the subset (1e-12)."""
    s = _targets(15)
    extent = 0.3
    plan, jplan = plan_type3(s, extent, 1e-9), jnufft.plan_type3(s, extent, 1e-9)
    ex, jex = Type3Executor(plan, device="cpu"), jax_transform.Type3Executor(jplan)
    m = s.shape[1]
    sel = {"all": None, "every third": np.arange(0, m, 3),
           "second half": np.arange(m // 2, m)}[part]
    (iy, ix), (vy, vx), order, runs = ex._taps(torch.float64, sel)
    off, ent = ex._tiles(torch.float64, sel)
    np.testing.assert_array_equal(off.numpy(), interp_mod.grid_tiles(
        iy.numpy(), ix.numpy(), runs.numpy(), plan.nf)[0])
    rng = np.random.default_rng(16)
    ms = m if sel is None else len(sel)
    g = rng.normal(size=(2, ms)) + 1j * rng.normal(size=(2, ms))
    got = _owned_tile_sum(g, vy.numpy(), vx.numpy(), order.numpy(), off.numpy(), ent.numpy(),
                          plan.nf)
    G = np.zeros((2,) + tuple(plan.nf), dtype=np.complex128)
    _, vjp = jax.vjp(lambda x: jex.interpolate(x, sel), jnp.asarray(G))
    assert np.isfinite(got).all()
    assert _rel(got, np.asarray(vjp(jnp.asarray(g))[0])) <= 1e-12


def test_lowrank_executor_pairs_match_single_pairs():
    rng = np.random.default_rng(13)
    s = np.concatenate([_targets(14, 300), rng.uniform(-2, 2, (1, 300))])
    zplan = plan_type3_lowrank_z(s, [0.3, 0.3, np.pi], 1e-9, x_range_z=(0.0, np.pi))
    ex = Type3LowrankZExecutor(zplan, device="cpu")
    K = ex.channel_multiplier
    sels = [np.arange(0, 300, 2), np.arange(1, 300, 2)]
    G = _crandn(rng, (2 * len(sels) * K,) + tuple(zplan.plan2d.nf))
    got = ex.interpolate_pairs(G, sels)
    for p, sel in enumerate(sels):
        want = ex.interpolate(G[p * 2 * K:(p + 1) * 2 * K], sel)
        assert got[p].shape == (2, len(sel)) and torch.equal(got[p], want)


# -------------------------------------- a multi-pair run against jax.grad

def _per_antenna_case(seed):
    rng = np.random.default_rng(seed)
    nant, nsrc = 6, 24
    ants = {i: np.array([*rng.uniform(-60, 60, 2), 0.0]) for i in range(nant)}
    freqs = np.array([1.0e8, 1.1e8])
    kw = dict(ants=ants, fluxes=rng.uniform(0.1, 1.0, (nsrc, 2)),
              ra=rng.uniform(0, 2 * np.pi, nsrc),
              dec=np.clip(LOC.lat + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2),
              freqs=freqs, times=2459863.2 + np.linspace(0, 0.02, 2), polarized=True,
              precision=2, force_use_type3=True, beam_idx=np.arange(nant) % 3)
    args = dict(n_az=36, n_za=19, freqs=tuple(float(f) for f in freqs))
    beams = [(GriddedBeam.from_function(GaussianBeam(diameter=10.0 + i), **args),
              JGriddedBeam.from_function(JGaussianBeam(diameter=10.0 + i), **args))
             for i in range(3)]
    return kw, beams


def test_multi_pair_gradient_matches_jax_and_takes_one_node():
    """Per-antenna beams (6 pairs of 3 beams) on forced type-3: the fluxes',
    table's and gains' gradients against jax.grad (1e-9 of max|grad|), and
    each (time, frequency)'s interpolation one InterpPairsFunction node that
    reads the whole grid (no slice of it)."""
    kw, beams = _per_antenna_case(15)
    sim, params = build_differentiable_sim(
        beam=[b[0] for b in beams], telescope_loc=LOC, device="cpu", nufft_mode="type3",
        differentiate_beam=True, differentiate_gains=True, **kw)
    jsim, jparams = fftvis_tpu.build_differentiable_sim(
        beam=[b[1] for b in beams], telescope_loc=JLOC, differentiate_beam=True,
        differentiate_gains=True, **kw)
    jp = {k: np.asarray(v, dtype=np.float64) for k, v in jparams.items()}
    p = params_from_reference(jp, params)
    want = np.asarray(jsim({k: jnp.asarray(v) for k, v in jp.items()}))
    vis = sim(p)
    assert _rel(vis.detach().numpy(), want) <= 1e-9
    data = want * 0.9
    jg = jax.grad(lambda q: jnp.sum(jnp.abs(jsim(q) - data) ** 2))(
        {k: jnp.asarray(v) for k, v in jp.items()})
    loss = (vis - torch.as_tensor(data)).abs().pow(2).sum()
    seen, stack, nodes = set(), [loss.grad_fn], {}
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        nodes[type(fn).__name__] = nodes.get(type(fn).__name__, 0) + 1
        if type(fn).__name__ == "InterpPairsFunctionBackward":
            grid = fn.next_functions[0][0]
            assert "Slice" not in type(grid).__name__
        stack.extend(f for f, _ in fn.next_functions)
    assert nodes.get("InterpPairsFunctionBackward") == 4  # 2 times x 2 frequencies
    grads = torch.autograd.grad(loss, list(p.values()))
    for key, g in zip(p, grads):
        assert _rel(g.numpy(), jg[key]) <= 1e-9, key


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_interp_adjoint_repeats_bitwise_and_fills_nothing(cuda_device, dtype):
    """Two calls are bitwise equal; the gradient comes from torch.empty (the
    allocator's blocks NaN-filled first) and every cell, touched or not, is
    written; the cells no tap reaches read exactly 0."""
    rng, order, iy, ix, vy, vx, runs = _tables(16, 3000, (200, 170), 14, "plan")
    nf = (200, 170)
    dev = cuda_device
    tabs = ([torch.tensor(a, dtype=torch.int32, device=dev) for a in (iy, ix)]
            + [torch.tensor(a, dtype=dtype, device=dev) for a in (vy, vx)])
    o = torch.tensor(order, dtype=torch.int32, device=dev)
    r = torch.tensor(runs, dtype=torch.int32, device=dev)
    tiles = interp_mod.tile_tensors(iy, ix, runs, nf, dev)
    g = _crandn(rng, (5, 3000), CDT[dtype]).to(dev)
    junk = torch.full((8 * 5 * nf[0] * nf[1],), float("nan"), dtype=dtype, device=dev)
    del junk
    got = interp_mod.interp_adjoint(g, *tabs, nf, order=o, runs=r, tiles=tiles)
    again = interp_mod.interp_adjoint(g, *tabs, nf, order=o, runs=r, tiles=tiles)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    touched = np.zeros(nf, dtype=bool)
    touched[iy[:, :, None], ix[:, None, :]] = True
    assert (got[:, torch.tensor(~touched, device=dev)] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_pair_rows_adjoint_repeats_bitwise(cuda_device, dtype):
    rng = np.random.default_rng(17)
    K, n = 37, 4096
    tri = [(i, j) for i in range(K) for j in range(i, K)][::4]
    evals = torch.tensor(rng.normal(size=(n, 8 * K)), dtype=dtype, device=cuda_device)
    pi, pj = (torch.tensor([p[k] for p in tri], dtype=torch.int32, device=cuda_device)
              for k in (0, 1))
    sky = torch.tensor(rng.uniform(0.1, 1, n), dtype=dtype, device=cuda_device)
    mask = torch.tensor(rng.uniform(size=n) < 0.7, dtype=dtype, device=cuda_device)
    g = _crandn(rng, (4 * len(tri), n), CDT[dtype]).to(cuda_device)
    args = (evals, pi, pj, sky, mask, g, (2, 2, 2), False, False)
    got, again = eval_mod.pair_rows_adjoint(*args), eval_mod.pair_rows_adjoint(*args)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_multi_pair_backward_fills_no_grid(cuda_device):
    """One backward of a multi-pair forced type-3 run on the card: the
    interpolation's gradient is one grid written by the tile kernel, one
    launch a pair; no fill or add touches a tensor of the grid's size."""
    from torch.profiler import ProfilerActivity, profile

    kw, beams = _per_antenna_case(18)
    sim, params = build_differentiable_sim(
        beam=[b[0] for b in beams], telescope_loc=LOC, device="cuda", nufft_mode="type3",
        differentiate_beam=True, **kw)
    loss = sim(params).abs().pow(2).sum()
    before = interp_mod.adjoint_launches
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
    assert interp_mod.adjoint_launches - before == 4 * 6  # (time, freq) x pairs
    shapes = [(ev.key, [int(np.prod(s)) for s in ev.input_shapes if s])
              for ev in prof.key_averages(group_by_input_shape=True)]
    biggest = max(n for _, ns in shapes for n in ns)
    assert not [k for k, ns in shapes
                if k in ("aten::fill_", "aten::zero_", "aten::add_", "aten::add")
                and biggest in ns]
