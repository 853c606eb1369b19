"""The port's tap interpolation vs the JAX package's interpolations.

On the CPU the port's ``interp`` runs its plain torch version. The same
plan (its tap tables) and the same grid go to both sides:

- float32, against ``PallasInterp(plan)(G)`` in interpret mode at the sizes
  of ``tests/test_pallas_interp.py``; atol 2e-5 * scale (float32 sums in
  two orders);
- float64, against the JAX executor's einsum gather at 1e-12 * scale.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fftvis_tpu.nufft.pallas_interp import PallasInterp
from fftvis_tpu.nufft.transform import Type3Executor as JaxExecutor
from fftvis_tpu.nufft.transform import plan_type3
from fftvis_tpu_torch.nufft.interp import interp
from fftvis_tpu_torch.nufft.transform import Type3Plan


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
