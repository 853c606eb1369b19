"""The port's type-3 planning and ES kernel math vs fftvis_tpu's.

Planning is host NumPy in both packages, so the port's plan must equal the
JAX package's array for array (``np.array_equal``), at the float32 eps
floor (5e-7) and the float64 default (1e-13). The torch evaluators of the
kernel and its Fourier transform are held to the NumPy/JAX ones at the
rounding of their dtype.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fftvis_tpu.nufft import kernels as jk
from fftvis_tpu.nufft import transform as jt
from fftvis_tpu_torch.nufft import kernels as pk
from fftvis_tpu_torch.nufft import transform as pt

EPS = [5e-7, 1e-13]


def _targets(seed, m=400):
    """Baseline-like targets: clustered core plus a sparse wide ring."""
    rng = np.random.default_rng(seed)
    core = rng.normal(0, 40.0, (2, m // 2))
    wide = rng.uniform(-300.0, 300.0, (2, m - m // 2))
    return np.concatenate([core, wide], axis=1)


def _assert_plans_equal(a, b):
    assert (a.kernel.w, a.kernel.beta, a.kernel.sigma, a.kernel.eps) == (
        b.kernel.w, b.kernel.beta, b.kernel.sigma, b.kernel.eps)
    assert a.d == b.d and a.nf == b.nf and a.n_targets == b.n_targets
    assert a.h == b.h and a.ds == b.ds and a.s_center == b.s_center
    assert a.ft_xi_max == b.ft_xi_max
    for name in ("deconv", "tap_idx", "tap_val", "ft_coefs"):
        xa, xb = getattr(a, name), getattr(b, name)
        assert len(xa) == len(xb)
        for u, v in zip(xa, xb):
            if u is None or v is None:
                assert u is None and v is None, name
            else:
                assert u.dtype == v.dtype, name
                assert np.array_equal(u, v), name


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("sigma", [2.0, 1.25])
def test_plan_type3_equals_reference(eps, sigma):
    s = _targets(1)
    x_ext = 2 * np.pi * 1.1e8 / 299792458.0
    got = pt.plan_type3(s, x_extent=x_ext, eps=eps, upsample_factor=sigma)
    want = jt.plan_type3(s, x_extent=x_ext, eps=eps, upsample_factor=sigma)
    _assert_plans_equal(got, want)


@pytest.mark.parametrize("eps", EPS)
def test_fit_plan_precorr_equals_reference(eps):
    s = _targets(2)
    got = pt.fit_plan_precorr(pt.plan_type3(s, 2.3, eps, fit_precorr=False))
    want = jt.fit_plan_precorr(jt.plan_type3(s, 2.3, eps, fit_precorr=False))
    _assert_plans_equal(got, want)
    assert all(c is not None for c in got.ft_coefs)


@pytest.mark.parametrize("eps", EPS)
def test_from_reference_round_trip(eps):
    s = _targets(3)
    ref = jt.plan_type3(s, x_extent=2.3, eps=eps)
    _assert_plans_equal(pt.Type3Plan.from_reference(ref), ref)
    _assert_plans_equal(
        pt.Type3Plan.from_reference(ref), pt.plan_type3(s, x_extent=2.3, eps=eps)
    )


@pytest.mark.parametrize("eps", [1e-2, 1e-4, 5e-7, 1e-10, 1e-13])
@pytest.mark.parametrize("sigma", [2.0, 1.25])
def test_kernel_parameters_equal_reference(eps, sigma):
    assert pk.ESKernel.from_eps(eps, sigma) == pk.ESKernel(
        **jk.ESKernel.from_eps(eps, sigma).__dict__
    )
    assert pk.next_fast_size(1000 + int(1e4 * eps)) == jk.next_fast_size(
        1000 + int(1e4 * eps)
    )


@pytest.mark.parametrize("eps", EPS)
def test_es_kernel_values(eps):
    kern = pk.ESKernel.from_eps(eps)
    t = np.linspace(-kern.w / 2 - 0.5, kern.w / 2 + 0.5, 1001)
    want = jk.es_kernel_grid(t, kern.w, kern.beta)
    assert np.array_equal(pk.es_kernel_grid(t, kern.w, kern.beta), want)
    got64 = pk.es_kernel_grid(torch.tensor(t), kern.w, kern.beta).numpy()
    np.testing.assert_allclose(got64, want, rtol=1e-14, atol=1e-300)
    t32 = t.astype(np.float32)
    got32 = pk.es_kernel_grid(torch.tensor(t32), kern.w, kern.beta).numpy()
    want32 = np.asarray(jk.es_kernel_grid(jnp.asarray(t32), kern.w, kern.beta, xp=jnp))
    np.testing.assert_allclose(got32, want32, rtol=2e-6, atol=1e-30)


@pytest.mark.parametrize("eps", EPS)
def test_es_kernel_ft_and_deconvolution(eps):
    kern = pk.ESKernel.from_eps(eps)
    xi = np.linspace(0.0, np.pi, 513)
    want = jk.es_kernel_ft(xi, kern.w, kern.beta)
    assert np.array_equal(pk.es_kernel_ft(xi, kern.w, kern.beta), want)
    got = pk.es_kernel_ft(torch.tensor(xi), kern.w, kern.beta).numpy()
    # An 80-term sum that cancels toward the band edge: its rounding is
    # absolute, on the scale of psi_hat(0).
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14 * want.max())
    # The plan's per-axis deconvolution vectors, on the device in float64.
    plan = pt.plan_type3(_targets(4), 2.3, eps)
    ex = pt.Type3Executor(plan, device="cpu")
    deconv = ex._deconv(torch.float64)
    for axis in range(2):
        assert np.array_equal(deconv[axis].numpy(), plan.deconv[axis])


def test_es_kernel_ft_cheb_matches_reference():
    kern = pk.ESKernel.from_eps(5e-7)
    xi_max = 1.02 * np.pi / 2
    coefs = pk.fit_log_ft_cheb(kern.w, kern.beta, xi_max)
    assert np.array_equal(coefs, jk.fit_log_ft_cheb(kern.w, kern.beta, xi_max))
    xi = np.linspace(-xi_max, xi_max, 777).astype(np.float32)
    got = pk.es_kernel_ft_cheb(torch.tensor(xi), coefs, xi_max).numpy()
    want = np.asarray(jk.es_kernel_ft_cheb(jnp.asarray(xi), coefs, xi_max, xp=jnp))
    np.testing.assert_allclose(got, want, rtol=2e-6)
    exact = jk.es_kernel_ft(xi.astype(np.float64), kern.w, kern.beta)
    np.testing.assert_allclose(got, exact, rtol=1e-6)
