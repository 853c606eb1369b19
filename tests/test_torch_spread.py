"""The port's spreader vs the JAX package's spreaders.

On the CPU the port's ``spread`` runs its plain torch version (the CUDA
kernel is held to that version on the card: ``test_torch_package.py`` and
``chip_smoke.py``). Inputs come from one NumPy seed and go to both sides:

- float32, against the Pallas band-accumulator spreader in interpret mode,
  parametrized like ``tests/test_pallas_spread.py``; atol 2e-5 * max|want|
  (two summation orders of float32 products);
- float64, against the XLA scatter spreader ``_spread_scatter`` at
  1e-12 * scale (same tap math, float64 rounding only);
- a coordinate that rounds to exactly nf in float32 wraps like the JAX
  spreaders wrap it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fftvis_tpu.nufft.kernels import ESKernel
from fftvis_tpu.nufft.pallas_spread import pallas_spread_ok, spread_pallas_tiled
from fftvis_tpu.nufft.transform import _spread_scatter
from fftvis_tpu_torch.nufft.spread import spread
from fftvis_tpu_torch.nufft.transform import _fmod_positive

GEOMETRIES = [
    (97, (64, 80), 16, 32),     # n < Pc, partial chunks
    (400, (48, 48), 16, 16),    # square tiles, heavy wraps
    (1000, (128, 96), 32, 24),  # multi-row bands
]


def _mk(n, nf, C, seed, cluster=False):
    rng = np.random.default_rng(seed)
    if cluster:
        uy = np.abs(rng.normal(0, 2.0, n)) % nf[0]
        ux = np.abs(rng.normal(0, 2.0, n)) % nf[1]
    else:
        uy = rng.uniform(0, nf[0], n)
        ux = rng.uniform(0, nf[1], n)
    w = rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
    return uy, ux, w


def _port(uy, ux, w, nf, kern, rdt, cdt):
    grid = torch.zeros((w.shape[0],) + tuple(nf), dtype=cdt)
    return spread(
        torch.tensor(uy, dtype=rdt), torch.tensor(ux, dtype=rdt),
        torch.tensor(w, dtype=cdt), grid, kern.w, kern.beta,
    ).numpy()


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("cluster", [False, True])
@pytest.mark.parametrize("n,nf,ty,sx", GEOMETRIES)
def test_spread_matches_pallas(n, nf, ty, sx, C, cluster):
    kern = ESKernel.from_eps(1e-6, sigma=2.0)
    uy, ux, w = _mk(n, nf, C, seed=n + C, cluster=cluster)
    uy32, ux32 = uy.astype(np.float32), ux.astype(np.float32)
    w64 = w.astype(np.complex64)
    assert pallas_spread_ok(nf, kern.w, ty, sx, 2 * C, n, np.float32)
    want = np.asarray(spread_pallas_tiled(
        [jnp.asarray(uy32), jnp.asarray(ux32)], jnp.asarray(w64),
        nf, kern.w, kern.beta, ty, sx,
    ))
    got = _port(uy32, ux32, w64, nf, kern, torch.float32, torch.complex64)
    scale = np.abs(want).max()
    assert got.shape == want.shape == (C,) + tuple(nf)
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=0)


def test_spread_matches_scatter_f64():
    n, nf = 400, (48, 48)  # heavy wraps
    kern = ESKernel.from_eps(1e-12, sigma=2.0)
    uy, ux, w = _mk(n, nf, 2, seed=7 * n)
    want = np.asarray(_spread_scatter(
        [jnp.asarray(uy), jnp.asarray(ux)], jnp.asarray(w), nf, kern.w, kern.beta,
    ))
    got = _port(uy, ux, w, nf, kern, torch.float64, torch.complex128)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-12 * scale, rtol=0)


def test_coordinate_rounding_to_nf_wraps():
    """x/h a hair below 0: mod nf in float32 rounds to exactly nf, one ulp
    past the last cell. The port's modulus gives the same value as
    jnp.mod, and its spreader wraps it like the JAX spreaders."""
    kern = ESKernel.from_eps(1e-6, sigma=2.0)
    nf = (64, 80)
    tiny = np.float32(-1e-6)
    u = _fmod_positive(torch.tensor([tiny]), nf[1]).numpy()
    assert u[0] == np.float32(nf[1])
    assert u[0] == np.asarray(jnp.mod(jnp.float32(tiny), nf[1]))
    uy = np.array([np.nextafter(np.float32(nf[0]), np.float32(0)), 3.5, 63.0],
                  dtype=np.float32)
    ux = np.array([u[0], np.float32(nf[1]), 0.25], dtype=np.float32)
    w = np.array([[1.0 + 0.5j, -0.3 + 2.0j, 0.7 - 1.1j]], dtype=np.complex64)
    got = _port(uy, ux, w, nf, kern, torch.float32, torch.complex64)
    j_u = [jnp.asarray(uy), jnp.asarray(ux)]
    want = np.asarray(_spread_scatter(j_u, jnp.asarray(w), nf, kern.w, kern.beta))
    pallas = np.asarray(spread_pallas_tiled(j_u, jnp.asarray(w), nf, kern.w, kern.beta, 16, 32))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-6 * scale, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=2e-5 * scale, rtol=0)
    # A source at exactly nf is the source at 0, periodically.
    at0 = _port(uy, np.array([0.0, 0.0, 0.25], np.float32), w, nf, kern,
                torch.float32, torch.complex64)
    np.testing.assert_allclose(got, at0, atol=2e-6 * scale, rtol=0)


@pytest.mark.parametrize("w", [1, 17])
def test_spread_width_outside_range_raises(w):
    uy = ux = torch.full((3,), 5.0)
    grid = torch.zeros((1, 32, 32), dtype=torch.complex64)
    with pytest.raises(ValueError, match="kernel width"):
        spread(uy, ux, torch.ones((1, 3), dtype=torch.complex64), grid, w, 9.0)


@pytest.mark.parametrize("rdt,cdt,tol", [(np.float32, np.complex64, 2e-6),
                                         (np.float64, np.complex128, 1e-12)])
def test_zero_weight_sources_add_nothing(rdt, cdt, tol):
    """Half the sources with all-zero weights (the horizon mask's rows):
    the grid equals the other half's alone, and the JAX scatter's grid."""
    n, nf, C = 400, (48, 64), 2
    kern = ESKernel.from_eps(1e-6 if rdt == np.float32 else 1e-12, sigma=2.0)
    uy, ux, w = _mk(n, nf, C, seed=5)
    uy, ux, w = uy.astype(rdt), ux.astype(rdt), w.astype(cdt)
    w[:, ::2] = 0
    got = _port(uy, ux, w, nf, kern, torch.tensor(uy).dtype, torch.tensor(w).dtype)
    half = _port(uy[1::2], ux[1::2], w[:, 1::2], nf, kern, torch.tensor(uy).dtype,
                 torch.tensor(w).dtype)
    want = np.asarray(_spread_scatter([jnp.asarray(uy), jnp.asarray(ux)], jnp.asarray(w),
                                      nf, kern.w, kern.beta))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, half, atol=tol * scale, rtol=0)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)
