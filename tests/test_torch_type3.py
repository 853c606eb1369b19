"""The port's Type3Executor vs fftvis_tpu's, on one plan, and vs the exact
direct sum.

Both executors hold the same plan (``Type3Plan.from_reference``) and get the
same sources and weights from one NumPy seed:

- float64: the two executors agree to 1e-13 * scale (same algorithm, float64
  rounding; the FFTs differ in summation order) and the port sits within
  1e-10 * scale of ``direct_type3_np`` (the plan's eps is 1e-12);
- float32: the executors agree to 5e-6 * scale (float32 rounding of
  ~200-rad pre-phases and of the FFT, in two frameworks) and the port sits
  within 1e-4 * scale of the exact sum, the repo's float32 gate.

The port's torch direct sum equals ``direct_type3_np`` to float64 rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fftvis_tpu.nufft.direct import direct_type3_np
from fftvis_tpu.nufft.transform import make_type3_fn, plan_type3
from fftvis_tpu_torch.nufft.direct import direct_type3
from fftvis_tpu_torch.nufft.transform import Type3Executor, Type3Plan

X_EXT = 2 * np.pi * 1.1e8 / 299792458.0


def _problem(seed, n=500, m=300, C=2):
    rng = np.random.default_rng(seed)
    s = np.concatenate(
        [rng.normal(0, 15.0, (2, m // 2)), rng.uniform(-120, 120, (2, m - m // 2))],
        axis=1,
    )
    x = rng.uniform(-X_EXT, X_EXT, (2, n)) * 0.7
    c = rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
    return s, x, c


def _port(plan, x, c, rdt, cdt):
    ex = Type3Executor(Type3Plan.from_reference(plan), device="cpu")
    g = ex.spread(torch.tensor(x, dtype=rdt), torch.tensor(c, dtype=cdt))
    return ex.interpolate(ex.transform(g)).numpy()


@pytest.mark.parametrize("C", [1, 2])
def test_type3_f64_matches_reference_and_direct(C):
    s, x, c = _problem(11 + C, C=C)
    plan = plan_type3(s, x_extent=X_EXT, eps=1e-12)
    got = _port(plan, x, c, torch.float64, torch.complex128)
    ref = np.asarray(make_type3_fn(plan)(jnp.asarray(x), jnp.asarray(c)))
    exact = direct_type3_np(x, c, s)
    scale = np.abs(exact).max()
    assert got.shape == ref.shape == (C, s.shape[1])
    np.testing.assert_allclose(got, ref, atol=1e-13 * scale, rtol=0)
    np.testing.assert_allclose(got, exact, atol=1e-10 * scale, rtol=0)


@pytest.mark.parametrize("C", [1, 2])
def test_type3_f32_matches_reference_and_direct(C):
    s, x, c = _problem(21 + C, C=C)
    plan = plan_type3(s, x_extent=X_EXT, eps=5e-7)
    x32, c64 = x.astype(np.float32), c.astype(np.complex64)
    got = _port(plan, x32, c64, torch.float32, torch.complex64)
    ref = np.asarray(make_type3_fn(plan)(jnp.asarray(x32), jnp.asarray(c64)))
    exact = direct_type3_np(x32.astype(np.float64), c64, s)
    scale = np.abs(exact).max()
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, atol=5e-6 * scale, rtol=0)
    np.testing.assert_allclose(got, exact, atol=1e-4 * scale, rtol=0)


def test_direct_type3_matches_numpy():
    s, x, c = _problem(5)
    got = direct_type3(torch.tensor(x), torch.tensor(c), s, source_block=128).numpy()
    want = direct_type3_np(x, c, s)
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max(), rtol=0)
