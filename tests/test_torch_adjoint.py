"""The adjoints of the port's kernels and their autograd Functions.

Each plain adjoint is held to the dot-product identity with its plain
forward, <A c, g> = <c, A^H g> (1e-12 relative in float64), and to
``torch.autograd`` of that forward; ``torch.autograd.gradcheck`` runs every
Function (``SpreadFunction``, ``InterpPairsFunction``, ``BeamEvalFunction``,
``BeamRowsFunction``, ``PairRowsFunction``) in float64 at tiny sizes, where
on the CPU its backward calls the plain adjoints. On a CUDA card (marked
``cuda``; skipped without one) each adjoint kernel is held to its plain
version: 1e-5 / 1e-12 of max|plain| in float32 / float64, because the
kernels sum in another order than the plain versions (the interp
adjoint's owned tiles in list order, the table's in point order).
"""

import numpy as np
import pytest
import torch

from fftvis_tpu_torch.beams import eval as eval_mod
from fftvis_tpu_torch.beams.gridded import GriddedBeam
from fftvis_tpu_torch.beams.interface import prepare_beam, prepare_beam_unpolarized
from fftvis_tpu_torch.nufft import interp as interp_mod
from fftvis_tpu_torch.nufft import spread as spread_mod
from fftvis_tpu_torch.nufft.kernels import ESKernel

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
CDT = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _inner(a, b) -> complex:
    """<a, b> = sum conj(a) b."""
    return complex((torch.conj(a) * b).sum())


def _crandn(rng, shape, dtype=torch.complex128):
    return torch.tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape), dtype=dtype)


# ------------------------------------------------------------------ spread

def _spread_case(seed, n=37, nf=(24, 20), C=2, w=6, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    uy = torch.tensor(rng.uniform(0, nf[0], n), dtype=dtype)
    ux = torch.tensor(rng.uniform(0, nf[1], n), dtype=dtype)
    beta = ESKernel.from_eps(1e-6, 2.0).beta * w / ESKernel.from_eps(1e-6, 2.0).w
    return rng, uy, ux, nf, C, w, beta


def test_spread_adjoint_dot_product_identity():
    rng, uy, ux, nf, C, w, beta = _spread_case(0)
    c = _crandn(rng, (C, uy.shape[0]))
    g = _crandn(rng, (C,) + nf)
    Ac = spread_mod.spread_plain(uy, ux, c, torch.zeros((C,) + nf, dtype=c.dtype), w, beta)
    AHg = spread_mod.spread_adjoint_plain(uy, ux, g, w, beta)
    lhs, rhs = _inner(Ac, g), _inner(c, AHg)
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_spread_adjoint_is_autograd_of_plain():
    rng, uy, ux, nf, C, w, beta = _spread_case(1)
    c = _crandn(rng, (C, uy.shape[0])).requires_grad_()
    g = _crandn(rng, (C,) + nf)
    out = spread_mod.spread_plain(uy, ux, c, torch.zeros((C,) + nf, dtype=c.dtype), w, beta)
    (want,) = torch.autograd.grad((torch.conj(g) * out).real.sum(), c)
    got = spread_mod.spread_adjoint(uy, ux, g, w, beta)
    assert torch.allclose(got, want, rtol=0, atol=1e-12 * want.abs().max().item())


def test_spread_function_gradcheck_and_in_place():
    rng, uy, ux, nf, C, w, beta = _spread_case(2, n=9, nf=(12, 10), w=4)
    c = _crandn(rng, (C, uy.shape[0])).requires_grad_()
    base = _crandn(rng, (C,) + nf).requires_grad_()

    def f(c, base):
        return spread_mod.spread(uy, ux, c, base.clone(), w, beta)

    assert torch.autograd.gradcheck(f, (c, base))
    grid = torch.zeros((C,) + nf, dtype=c.dtype)
    out = spread_mod.spread(uy, ux, c, grid, w, beta)
    assert out is grid and out.grad_fn is not None  # accumulated in place


# ------------------------------------------------------------------ interp

def _interp_case(seed, m=23, nf=(16, 14), C=2, w=4, dtype=torch.float64, repeat=True):
    """Tap tables of w consecutive cells mod nf, some targets repeated (runs
    of more than one row), in target order with a footprint order."""
    rng = np.random.default_rng(seed)
    i0 = np.stack([rng.integers(0, nf[0], m), rng.integers(0, nf[1], m)])
    if repeat:
        i0[:, m // 2:] = i0[:, :1]  # half the targets share the first footprint
    iy = (i0[0][:, None] + np.arange(w)) % nf[0]
    ix = (i0[1][:, None] + np.arange(w)) % nf[1]
    vy, vx = rng.uniform(0.1, 1, (m, w)), rng.uniform(0.1, 1, (m, w))
    order = interp_mod.target_order(iy[:, 0], ix[:, 0])
    runs = interp_mod.footprint_runs(iy[order], ix[order])
    rows = [torch.tensor(a[order], dtype=torch.int32) for a in (iy, ix)]
    rows += [torch.tensor(a[order], dtype=dtype) for a in (vy, vx)]
    plain = [torch.tensor(iy, dtype=torch.int32), torch.tensor(ix, dtype=torch.int32),
             torch.tensor(vy, dtype=dtype), torch.tensor(vx, dtype=dtype)]
    return (rng, rows, torch.tensor(order, dtype=torch.int32),
            torch.tensor(runs, dtype=torch.int32), plain, nf, C)


def test_interp_adjoint_dot_product_identity():
    rng, rows, order, runs, plain, nf, C = _interp_case(3)
    G = _crandn(rng, (C,) + nf)
    g = _crandn(rng, (C, order.shape[0]))
    AG = interp_mod.interp(G, *rows, order=order, runs=runs)
    AHg = interp_mod.interp_adjoint(g, *rows, nf, order=order, runs=runs)
    lhs, rhs = _inner(AG, g), _inner(G, AHg)
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_interp_adjoint_is_autograd_of_plain():
    rng, rows, order, runs, plain, nf, C = _interp_case(4)
    G = _crandn(rng, (C,) + nf).requires_grad_()
    g = _crandn(rng, (C, order.shape[0]))
    out = interp_mod.interp_plain(G, *plain)
    (want,) = torch.autograd.grad((torch.conj(g) * out).real.sum(), G)
    got = interp_mod.interp_adjoint_plain(g, *plain, *nf)
    assert torch.allclose(got, want, rtol=0, atol=1e-12 * want.abs().max().item())


def test_interp_function_gradcheck():
    rng, rows, order, runs, plain, nf, C = _interp_case(5, m=11, nf=(8, 9), w=3)
    G = _crandn(rng, (C,) + nf).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda G: interp_mod.interp(G, *rows, order=order, runs=runs), (G,))


# --------------------------------------------------------------- beam_eval

def _eval_case(seed, order, wrap, npts=29, shape=(9, 12, 5), dtype=torch.float64):
    """A table and points kept a little off the cell edges (order 1 is
    piecewise linear there) and inside the clamped rows."""
    rng = np.random.default_rng(seed)
    ny, nx, ch = shape
    data = torch.tensor(rng.normal(size=shape), dtype=dtype)
    y = rng.integers(0, ny - 1, npts) + rng.uniform(0.05, 0.95, npts)
    x = rng.integers(0, nx if wrap else nx - 1, npts) + rng.uniform(0.05, 0.95, npts)
    if wrap:
        x[:3] += nx * np.array([-1, 1, 2])  # folded around the seam
    return rng, data, torch.tensor(y, dtype=dtype), torch.tensor(x, dtype=dtype)


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("order", [1, 3])
def test_beam_eval_adjoint_dot_product_identity(order, wrap):
    rng, data, y, x = _eval_case(6, order, wrap)
    g = torch.tensor(rng.normal(size=(y.shape[0], data.shape[2])), dtype=data.dtype)
    out = eval_mod.beam_eval_plain(data, y, x, order, wrap)
    gdata, _, _ = eval_mod.beam_eval_adjoint(data, y, x, g, order, wrap)
    lhs, rhs = float((out * g).sum()), float((data * gdata).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("order", [1, 3])
def test_beam_eval_adjoint_is_autograd_of_plain(order, wrap):
    rng, data, y, x = _eval_case(7, order, wrap)
    data, y, x = (t.clone().requires_grad_() for t in (data, y, x))
    g = torch.tensor(rng.normal(size=(y.shape[0], data.shape[2])), dtype=data.dtype)
    out = eval_mod.beam_eval_plain(data, y, x, order, wrap)
    want = torch.autograd.grad((out * g).sum(), (data, y, x))
    got = eval_mod.beam_eval_adjoint(data.detach(), y.detach(), x.detach(), g, order, wrap,
                                     table=True, coords=True)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=0, atol=1e-12 * b.abs().max().item())


def test_beam_eval_adjoint_clamped_edge_has_no_slope():
    """Order 1, clamped: a coordinate past the last row gets no derivative,
    as torch's clamp gives none."""
    data = torch.arange(24.0, dtype=torch.float64).reshape(4, 3, 2)
    y = torch.tensor([3.5, 1.25], dtype=torch.float64)
    x = torch.tensor([1.5, 0.5], dtype=torch.float64)
    g = torch.ones((2, 2), dtype=torch.float64)
    _, gy, gx = eval_mod.beam_eval_adjoint(data, y, x, g, 1, False, table=False, coords=True)
    assert gy[0] == 0 and gy[1] != 0 and torch.all(gx != 0)


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("order", [1, 3])
def test_beam_eval_function_gradcheck(order, wrap):
    _, data, y, x = _eval_case(8, order, wrap, npts=7, shape=(6, 7, 3))
    args = tuple(t.clone().requires_grad_() for t in (data, y, x))
    assert torch.autograd.gradcheck(
        lambda d, yy, xx: eval_mod.beam_eval(d, yy, xx, order=order, wrap_x=wrap), args)


# ---------------------------------------------------------- beam_rows / pair_rows

FREQS = np.array([1.05e8, 1.15e8])


def _table_beam(seed, nza=11, naz=16):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(2, 2, 2, nza, naz)) + 1j * rng.normal(size=(2, 2, 2, nza, naz))
    az = np.linspace(0, 2 * np.pi, naz, endpoint=False)
    za = np.linspace(0, np.pi / 2, nza)
    return GriddedBeam(data, az, za, [1.0e8, 1.2e8], "efield", feeds=["x", "y"])


def _points(rng, n):
    az = torch.tensor(rng.uniform(0, 2 * np.pi, n))
    za = torch.tensor(rng.uniform(0, np.pi / 2 - 0.1, n))
    mask = torch.tensor((rng.uniform(size=n) > 0.3).astype(float))
    return az, za, mask


def _sky(rng, n, iquv):
    if not iquv:
        return torch.tensor(rng.uniform(0.1, 1, n)).requires_grad_()
    return _crandn(rng, (n, 2, 2)).requires_grad_()


@pytest.mark.parametrize("case", ["power", "jones-I", "jones-iquv"])
def test_beam_rows_function_gradcheck(case):
    rng = np.random.default_rng(9)
    beam = _table_beam(9)
    polarized = case != "power"
    if not polarized:
        beam = prepare_beam_unpolarized(beam)
    pb = prepare_beam(beam, FREQS, polarized, spline_opts={"order": 3}, device="cpu")
    az, za, mask = _points(rng, 13)
    iquv = case == "jones-iquv"
    sky = _sky(rng, 13, iquv)
    assert torch.autograd.gradcheck(
        lambda s: eval_mod.beam_rows(pb.table[0], az, za, s, mask, pb.grid, iquv), (sky,))


@pytest.mark.parametrize("case", ["power", "jones-I", "jones-iquv"])
def test_pair_rows_function_gradcheck(case):
    rng = np.random.default_rng(10)
    n, K = 11, 3
    power = case == "power"
    ch_shape = (1, 2) if power else (2, 2, 2)
    chf = int(np.prod(ch_shape))
    evals = torch.tensor(rng.uniform(0.2, 1.0, (n, K * chf)))
    if not power:
        evals = evals - 0.6
    evals.requires_grad_()
    pair_i = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    pair_j = torch.tensor([0, 2, 1, 2], dtype=torch.int32)
    mask = torch.tensor((rng.uniform(size=n) > 0.3).astype(float))
    iquv = case == "jones-iquv"
    sky = _sky(rng, n, iquv)
    assert torch.autograd.gradcheck(
        lambda e, s: eval_mod.pair_rows(e, pair_i, pair_j, s, mask, ch_shape, power, iquv,
                                        feed=1),
        (evals, sky))


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, want) -> float:
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("w", [4, 7, 14])
def test_cuda_spread_adjoint_matches_plain(cuda_device, w, dtype):
    rng, uy, ux, nf, C, _, beta = _spread_case(11, n=3000, nf=(96, 80), C=3, w=w, dtype=dtype)
    uy, ux = uy.to(cuda_device), ux.to(cuda_device)
    g = _crandn(rng, (C,) + nf, CDT[dtype]).to(cuda_device)
    before = spread_mod.adjoint_launches
    got = spread_mod.spread_adjoint(uy, ux, g, w, beta)
    assert spread_mod.adjoint_launches == before + 1
    want = spread_mod.spread_adjoint_plain(uy, ux, g, w, beta)
    assert _rel(got, want) <= TOL[dtype]
    # No atomics and a fixed order of summation: two calls agree bit for bit.
    again = spread_mod.spread_adjoint(uy, ux, g, w, beta)
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("w", [4, 7, 14, 16])
@pytest.mark.parametrize("C,n", [(40, 4096), (40, 4095), (4, 4095), (1, 4095)])
def test_cuda_spread_adjoint_channels_ragged_wrap(cuda_device, C, n, w, dtype):
    """``spread_adjoint_gm`` at few and many channels, a ragged last block
    and widths that leave lanes idle (w^2 not a multiple of 32), with
    sources on the wrap; bitwise repeatable."""
    rng, uy, ux, nf, C, _, beta = _spread_case(13, n=n, nf=(200, 168), C=C, w=w, dtype=dtype)
    uy[:3] = torch.tensor([float(nf[0]), 0.25, nf[0] - 0.5], dtype=dtype)
    ux[:3] = torch.tensor([0.0, nf[1] - 0.25, 0.5], dtype=dtype)
    uy, ux = uy.to(cuda_device), ux.to(cuda_device)
    g = _crandn(rng, (C,) + nf, CDT[dtype]).to(cuda_device)
    want = spread_mod.spread_adjoint_plain(uy, ux, g, w, beta)
    got = spread_mod.spread_adjoint(uy, ux, g, w, beta)
    assert _rel(got, want) <= TOL[dtype]
    again = spread_mod.spread_adjoint(uy, ux, g, w, beta)
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("repeat", [True, False])
def test_cuda_interp_adjoint_matches_plain(cuda_device, repeat, dtype):
    rng, rows, order, runs, plain, nf, C = _interp_case(12, m=2000, nf=(64, 48), C=3, w=8,
                                                        dtype=dtype, repeat=repeat)
    tiles = interp_mod.tile_tensors(rows[0].numpy(), rows[1].numpy(), runs.numpy(), nf,
                                    cuda_device)
    rows = [t.to(cuda_device) for t in rows]
    g = _crandn(rng, (C, order.shape[0]), CDT[dtype]).to(cuda_device)
    before = interp_mod.adjoint_launches
    got = interp_mod.interp_adjoint(g, *rows, nf, order=order.to(cuda_device),
                                    runs=runs.to(cuda_device), tiles=tiles)
    assert interp_mod.adjoint_launches == before + 1
    want = interp_mod.interp_adjoint_plain(g, *[t.to(cuda_device) for t in plain], *nf)
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("ch", [5, 16])
def test_cuda_beam_eval_adjoint_matches_plain(cuda_device, ch, order, wrap, dtype):
    rng, data, y, x = _eval_case(13, order, wrap, npts=3000, shape=(31, 40, ch), dtype=dtype)
    data, y, x = data.to(cuda_device), y.to(cuda_device), x.to(cuda_device)
    g = torch.tensor(rng.normal(size=(y.shape[0], ch)), dtype=dtype, device=cuda_device)
    before = eval_mod.adjoint_launches
    got = eval_mod.beam_eval_adjoint(data, y, x, g, order, wrap, table=True, coords=True)
    assert eval_mod.adjoint_launches == before + 1
    want = eval_mod.beam_eval_adjoint_plain(data, y, x, g, order, wrap, table=True,
                                            coords=True)
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL[dtype]
