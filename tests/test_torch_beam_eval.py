"""The port's beam-table evaluator and spline prefilter vs the JAX package.

Same NumPy inputs, made from a seed, go through:

- ``beam_eval`` on CPU tensors (its plain torch version) and the JAX
  package's ``map_coordinates_2d_cl`` gather and ``pallas_map_coordinates_cl``
  TPU kernel (interpret mode on the CPU), at the shapes of
  ``tests/test_pallas_beam_eval.py``: (91, 181, 8), (21, 40, 3), a wrapped
  5-column table and period-boundary x; orders 1 and 3, wrap and clamp.
  Tolerances: 2e-6 of max|ref| in float32 (the kernels sum taps in another
  order), 1e-12 in float64 against the gather (one algorithm in float64).
  Order-1 float64 points stay below ``ny-1``: there the JAX gather's clip
  reads row ``ny-2``; the port reads row ``ny-1`` like the TPU kernel, which
  a separate case holds it to.
- ``spline_prefilter_2d``, mirror and periodic, at 1e-12.

On a CUDA card (marked ``cuda``; skipped without one) the kernel is held to
the plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fftvis_tpu.beams.interp import map_coordinates_2d as jax_map_coordinates_2d
from fftvis_tpu.beams.interp import map_coordinates_2d_cl
from fftvis_tpu.beams.interp import spline_prefilter_2d as jax_prefilter
from fftvis_tpu.beams.pallas_eval import pallas_map_coordinates_cl
from fftvis_tpu_torch.beams import eval as eval_mod
from fftvis_tpu_torch.beams import map_coordinates_2d, spline_prefilter_2d

F32_TOL = 2e-6
F64_TOL = 1e-12


def _coords(n, ny, nx, seed, edges=True):
    rng = np.random.default_rng(seed)
    y = rng.uniform(-0.5, ny - 0.5, n)
    x = rng.uniform(-1.0, nx + 1.0, n)
    if edges:
        k = n // 8
        y[:k] = rng.uniform(-0.99, 0.99, k)
        y[k : 2 * k] = rng.uniform(ny - 1.99, ny - 0.01, k)
        x[:k] = rng.uniform(-0.99, 0.99, k)
        x[k : 2 * k] = rng.uniform(nx - 1.99, nx + 0.99, k)
    return y, x


def _table(ny, nx, ch, order, seed, dtype=np.float32, wrap=False):
    data = np.random.default_rng(seed).normal(size=(ny, nx, ch))
    if order == 3:
        data = spline_prefilter_2d(data, axes=(0, 1), periodic_x=wrap)
    return data.astype(dtype)


def _port(data, y, x, order, wrap):
    t = torch.from_numpy
    return eval_mod.beam_eval(t(data), t(y.astype(data.dtype)), t(x.astype(data.dtype)),
                              order=order, wrap_x=wrap).numpy()


def _jax(fn, data, y, x, order, wrap):
    dt = data.dtype
    return np.asarray(fn(jnp.asarray(data), jnp.asarray(y, dt), jnp.asarray(x, dt),
                         order=order, wrap_x=wrap))


def _close(got, want, tol):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("ny,nx,ch", [(91, 181, 8), (21, 40, 3)])
def test_beam_eval_matches_gather_and_pallas_f32(order, wrap, ny, nx, ch):
    data = _table(ny, nx, ch, order, seed=order * 10 + wrap, wrap=wrap)
    y, x = _coords(700, ny, nx, seed=ny + order)
    got = _port(data, y, x, order, wrap)
    _close(got, _jax(map_coordinates_2d_cl, data, y, x, order, wrap), F32_TOL)
    _close(got, _jax(pallas_map_coordinates_cl, data, y, x, order, wrap), F32_TOL)


@pytest.mark.parametrize("order", [1, 3])
def test_beam_eval_narrow_wrapped_table(order):
    """nx=5 < the TPU kernel's 8-column pads: the port needs no pads."""
    data = _table(12, 5, 2, order, seed=7, wrap=True)
    y, x = _coords(300, 12, 5, seed=8)
    got = _port(data, y, x, order, True)
    _close(got, _jax(map_coordinates_2d_cl, data, y, x, order, True), F32_TOL)
    _close(got, _jax(pallas_map_coordinates_cl, data, y, x, order, True), F32_TOL)


@pytest.mark.parametrize("order", [1, 3])
def test_beam_eval_period_boundary(order):
    """x at exact multiples of the period and one period out."""
    rng = np.random.default_rng(1)
    ny, nx, ch = 104, 110, 3
    data = _table(ny, nx, ch, order, seed=2, wrap=True)
    n = 64
    y = rng.uniform(0, ny - 1, n)
    x = np.concatenate([
        rng.uniform(nx, nx + 1, 16), rng.uniform(-nx - 1, -nx, 16),
        [0.0, float(nx), float(2 * nx), -float(nx)], rng.uniform(0, nx, n - 36),
    ])
    got = _port(data, y, x, order, True)
    _close(got, _jax(map_coordinates_2d_cl, data, y, x, order, True), F32_TOL)
    _close(got, _jax(pallas_map_coordinates_cl, data, y, x, order, True), F32_TOL)


@pytest.mark.parametrize("order", [1, 3])
def test_beam_eval_edge_rows_follow_the_tpu_kernel(order):
    """y at and beyond the last row, and below the first, at exact cells."""
    ny, nx, ch = 91, 36, 4
    data = _table(ny, nx, ch, order, seed=3, wrap=True)
    y = np.array([ny - 1, ny - 0.5, ny - 1 + 1e-3, ny + 0.3, 0.0, -0.2, -1.0, 45.0])
    x = np.array([0.0, nx, nx - 1e-3, 17.5, 3.25, nx + 0.5, -0.5, 35.0])
    got = _port(data, y, x, order, True)
    _close(got, _jax(pallas_map_coordinates_cl, data, y, x, order, True), F32_TOL)
    if order == 1:
        # y >= ny-1 reads row ny-1 exactly (the JAX float64 gather: ny-2).
        np.testing.assert_array_equal(got[0], data[ny - 1, 0])


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("wrap", [True, False])
def test_beam_eval_matches_gather_f64(order, wrap):
    ny, nx, ch = 91, 181, 8
    data = _table(ny, nx, ch, order, seed=5, dtype=np.float64, wrap=wrap)
    y, x = _coords(700, ny, nx, seed=6)
    if order == 1:
        y = np.minimum(y, ny - 1 - 1e-6)
        if not wrap:  # the JAX clamped-x clip has the same quirk
            x = np.minimum(x, nx - 1 - 1e-6)
    _close(_port(data, y, x, order, wrap),
           _jax(map_coordinates_2d_cl, data, y, x, order, wrap), F64_TOL)


@pytest.mark.parametrize("periodic", [False, True])
def test_spline_prefilter_matches_reference(periodic):
    data = np.random.default_rng(4).normal(size=(2, 3, 19, 24))
    got = spline_prefilter_2d(data, periodic_x=periodic)
    want = np.asarray(jax_prefilter(jnp.asarray(data), periodic_x=periodic))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=F64_TOL * np.abs(want).max(), rtol=0)


def test_spline_prefilter_reconstructs_the_table_at_the_nodes():
    """Periodic coefficients evaluated at the nodes give the table back,
    across the seam too."""
    data = np.random.default_rng(9).normal(size=(15, 20, 2))
    coeff = spline_prefilter_2d(data, axes=(0, 1), periodic_x=True)
    yy, xx = np.meshgrid(np.arange(15.0), np.arange(20.0), indexing="ij")
    got = _port(coeff, yy.ravel(), xx.ravel(), 3, True)
    np.testing.assert_allclose(got, data.reshape(-1, 2), atol=1e-12, rtol=0)


@pytest.mark.parametrize("order,wrap", [(1, True), (3, True), (3, False)])
def test_map_coordinates_2d_matches_reference(order, wrap):
    rng = np.random.default_rng(11)
    data = rng.normal(size=(2, 2, 21, 40)) + 1j * rng.normal(size=(2, 2, 21, 40))
    y = rng.uniform(0, 19.9, 50)
    x = rng.uniform(-1, 41, 50)
    got = map_coordinates_2d(torch.from_numpy(data), torch.from_numpy(y),
                             torch.from_numpy(x), order=order, wrap_x=wrap).numpy()
    want = np.asarray(jax_map_coordinates_2d(jnp.asarray(data), jnp.asarray(y),
                                             jnp.asarray(x), order=order, wrap_x=wrap))
    assert got.shape == want.shape == (2, 2, 50)
    np.testing.assert_allclose(got, want, atol=F64_TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("case", ["dtype", "mixed", "shape", "order", "layout", "points"])
def test_beam_eval_wrapper_refuses(case):
    data = torch.zeros((6, 8, 2), dtype=torch.float32)
    y = torch.zeros(5, dtype=torch.float32)
    x = torch.zeros(5, dtype=torch.float32)
    order = 1
    if case == "dtype":
        data, y, x = data.half(), y.half(), x.half()
    elif case == "mixed":
        y = y.double()
    elif case == "shape":
        data = data[0]
    elif case == "order":
        order = 2
    elif case == "layout":
        data = torch.zeros((6, 16, 2), dtype=torch.float32)[:, ::2]
    elif case == "points":
        x = torch.zeros(4, dtype=torch.float32)
    with pytest.raises((TypeError, ValueError)):
        eval_mod.beam_eval(data, y, x, order=order)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.float64, F64_TOL)])
def test_cuda_beam_eval_matches_plain(cuda_device, order, dtype, tol):
    ny, nx, ch = 91, 360, 8
    data = torch.tensor(_table(ny, nx, ch, order, seed=1, dtype=np.float64, wrap=True),
                        dtype=dtype, device=cuda_device)
    y, x = (torch.tensor(a, dtype=dtype, device=cuda_device)
            for a in _coords(4096, ny, nx, seed=2))
    before = eval_mod.launches
    got = eval_mod.beam_eval(data, y, x, order=order, wrap_x=True)
    assert eval_mod.launches == before + 1
    want = eval_mod.beam_eval_plain(data, y, x, order=order, wrap_x=True)
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()
