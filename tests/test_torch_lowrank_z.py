"""The low-rank-z 3D type-3 transform: the port's plan and executor on the
CPU against ``fftvis_tpu`` and the dense DFT.

- ``plan_type3_lowrank_z`` gives the JAX function's arrays (K, ``g``, the z
  centre and half-width, the 2D plan) on the four cases of
  ``tests/test_nufft.py::test_type3_lowrank_z_matches_direct``, and its
  ``ValueError`` past ``max_modes``;
- ``Type3LowrankZExecutor`` on a plan carried across with
  ``Type3LowrankZPlan.from_reference`` gives ``make_type3_lowrank_z_fn``'s
  result within 1e-9 (complex128) and 1e-4 (complex64) of max, and the
  dense DFT within 50 eps;
- masked sources outside the planned z range stay finite (the clamp);
- ``interpolate(sel)`` equals the full result's columns;
- the grid's channels are c*K + k: channel c's K modes interpolate to that
  channel's result alone.

The spread and interpolation take their plain torch versions here (CPU
tensors); the card's kernels at these C*K shapes are held to them in
``chip_smoke.py`` phase 3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fftvis_tpu.nufft import transform as jax_transform
from fftvis_tpu_torch.nufft.transform import (
    Type3LowrankZExecutor,
    Type3LowrankZPlan,
    make_type3_lowrank_z_fn,
    plan_type3_lowrank_z,
)

X = np.pi
CASES = [(5.0, 1e-6, 0.0), (5.0, 1e-10, 0.0), (30.0, 1e-8, 0.0), (0.5, 1e-12, -np.pi)]


def _problem(zspread, zlo, seed=11, n=600, m=250, C=3):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(-X, X, n), rng.uniform(-X, X, n), rng.uniform(zlo, X, n)])
    s = np.stack([rng.uniform(-60, 60, m), rng.uniform(-60, 60, m),
                  rng.uniform(-zspread, zspread, m)])
    c = rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
    return x, s, c


def _port_run(zplan, x, c, rdt=torch.float64, cdt=torch.complex128):
    fn = make_type3_lowrank_z_fn(Type3LowrankZPlan.from_reference(zplan), device="cpu")
    return fn(torch.tensor(x, dtype=rdt), torch.tensor(c, dtype=cdt)).numpy()


@pytest.mark.parametrize("zspread,eps,zlo", CASES)
def test_plan_copy_matches_reference(zspread, eps, zlo):
    _, s, _ = _problem(zspread, zlo)
    got = plan_type3_lowrank_z(s, [X, X, X], eps=eps, x_range_z=(zlo, X))
    want = jax_transform.plan_type3_lowrank_z(s, [X, X, X], eps=eps, x_range_z=(zlo, X))
    assert (got.K, got.s_center_z, got.x_center_z, got.x_half_z, got.n_targets) == (
        want.K, want.s_center_z, want.x_center_z, want.x_half_z, want.n_targets)
    np.testing.assert_array_equal(got.g, want.g)
    gp, wp = got.plan2d, want.plan2d
    assert (gp.nf, gp.h, gp.ds, gp.s_center, gp.kernel.w) == (wp.nf, wp.h, wp.ds,
                                                               wp.s_center, wp.kernel.w)
    for a, b in zip(gp.tap_idx + gp.tap_val + gp.deconv, wp.tap_idx + wp.tap_val + wp.deconv):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(gp.ft_coefs, wp.ft_coefs):
        np.testing.assert_array_equal(a, b)
    zh = 0.5 * (X - zlo)
    assert got.K <= zspread * zh + 14 * np.log10(1.0 / eps) + 16


def test_plan_refuses_past_max_modes():
    _, s, _ = _problem(30.0, 0.0)
    with pytest.raises(ValueError) as want:
        jax_transform.plan_type3_lowrank_z(s, [X, X, X], eps=1e-8, x_range_z=(0.0, X),
                                           max_modes=40)
    with pytest.raises(ValueError) as got:
        plan_type3_lowrank_z(s, [X, X, X], eps=1e-8, x_range_z=(0.0, X), max_modes=40)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("zspread,eps,zlo", CASES)
def test_executor_f64_matches_reference_and_dft(zspread, eps, zlo):
    x, s, c = _problem(zspread, zlo)
    zplan = jax_transform.plan_type3_lowrank_z(s, [X, X, X], eps=eps, x_range_z=(zlo, X))
    got = _port_run(zplan, x, c)
    ref = np.asarray(jax.jit(jax_transform.make_type3_lowrank_z_fn(zplan))(jnp.asarray(x),
                                                                          jnp.asarray(c)))
    want = c @ np.exp(1j * (x.T @ s))
    scale = np.abs(want).max()
    assert got.shape == ref.shape == (c.shape[0], s.shape[1])
    assert np.abs(got - ref).max() <= 1e-9 * scale
    assert np.abs(got - want).max() <= 50 * eps * scale


def test_executor_f32_matches_reference_and_dft():
    x, s, c = _problem(5.0, 0.0, seed=21)
    zplan = jax_transform.plan_type3_lowrank_z(s, [X, X, X], eps=5e-7, x_range_z=(0.0, X))
    x32, c64 = x.astype(np.float32), c.astype(np.complex64)
    got = _port_run(zplan, x32, c64, torch.float32, torch.complex64)
    ref = np.asarray(jax.jit(jax_transform.make_type3_lowrank_z_fn(zplan))(jnp.asarray(x32),
                                                                          jnp.asarray(c64)))
    want = c64.astype(np.complex128) @ np.exp(1j * (x32.astype(np.float64).T @ s))
    scale = np.abs(want).max()
    assert got.dtype == np.complex64
    assert np.abs(got - ref).max() <= 1e-4 * scale
    assert np.abs(got - want).max() <= 1e-4 * scale


def test_out_of_range_masked_sources_stay_finite():
    """Zero-weight sources below the planned z range (the engine's masked
    below-horizon sources) must not overflow the Chebyshev recurrence."""
    rng = np.random.default_rng(12)
    n, m = 100, 50
    x = np.stack([rng.uniform(-X, X, n), rng.uniform(-X, X, n), rng.uniform(0, X, n)])
    x[2, 50:] = rng.uniform(-X, -0.2, 50)
    c = rng.normal(size=(1, n)) + 1j * rng.normal(size=(1, n))
    c[:, 50:] = 0.0
    s = np.stack([rng.uniform(-40, 40, m), rng.uniform(-40, 40, m), rng.uniform(-3, 3, m)])
    zplan = plan_type3_lowrank_z(s, [X, X, X], eps=1e-8, x_range_z=(0.0, X))
    got = make_type3_lowrank_z_fn(zplan, device="cpu")(torch.tensor(x), torch.tensor(c)).numpy()
    assert np.all(np.isfinite(got))
    want = c[:, :50] @ np.exp(1j * (x[:, :50].T @ s))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_interpolate_subset_equals_full_columns():
    rng = np.random.default_rng(13)
    n, m = 200, 60
    x = np.stack([rng.uniform(-X, X, n), rng.uniform(-X, X, n), rng.uniform(0, X, n)])
    s = np.stack([rng.uniform(-40, 40, m), rng.uniform(-40, 40, m), rng.uniform(-4, 4, m)])
    c = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    ex = Type3LowrankZExecutor(plan_type3_lowrank_z(s, [X, X, X], eps=1e-9,
                                                    x_range_z=(0.0, X)), device="cpu")
    G = ex.transform(ex.spread(torch.tensor(x), torch.tensor(c)))
    sel = np.array([3, 17, 41, 59])
    a, b = ex.interpolate(G).numpy(), ex.interpolate(G, sel).numpy()
    np.testing.assert_allclose(b, a[:, sel], rtol=0, atol=1e-12 * np.abs(a).max())


def test_channel_layout_is_c_times_k_plus_k():
    """The grid of C channels holds C*K planes, channel c's z modes at c*K +
    k: interpolating the slice of channel c gives channel c's result (the
    per-pair slices of the engine's assembly)."""
    x, s, c = _problem(5.0, 0.0, seed=31, n=300, m=80, C=4)
    ex = Type3LowrankZExecutor(plan_type3_lowrank_z(s, [X, X, X], eps=1e-10,
                                                    x_range_z=(0.0, X)), device="cpu")
    K = ex.channel_multiplier
    G = ex.transform(ex.spread(torch.tensor(x), torch.tensor(c)))
    assert G.shape[0] == 4 * K and ex.zplan.K == K > 1
    full = ex.interpolate(G).numpy()
    sel = np.arange(0, 80, 3)
    for p in range(2):  # two "pairs" of two channels each
        part = ex.interpolate(G[2 * p * K:2 * (p + 1) * K], sel).numpy()
        np.testing.assert_allclose(part, full[2 * p:2 * (p + 1)][:, sel], rtol=0,
                                   atol=1e-12 * np.abs(full).max())
        alone = ex.interpolate(ex.transform(ex.spread(torch.tensor(x),
                                                      torch.tensor(c[2 * p:2 * p + 2]))))
        np.testing.assert_allclose(alone.numpy(), full[2 * p:2 * p + 2], rtol=0,
                                   atol=1e-12 * np.abs(full).max())
