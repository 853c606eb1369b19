"""The spread's adjoint with respect to the weights, on the CPU.

- ``spread_adjoint_plain`` against ``jax.vjp`` of the JAX package's
  ``_spread_scatter`` (``fftvis_tpu/nufft/transform.py``) in the weights,
  at d = 2, C = 1, 4 and 40, float64, inputs from a NumPy seed, 1e-12
  relative to the largest entry. Conjugation: JAX's vjp of the complex
  linear map w -> A w is ct -> A^T ct; the ES values are real, so A^T =
  A^H, and the plain adjoint (a gather of each source's taps times their
  real ES values) is the same map with no conjugate on either side.
- the wrapper's checks: ``spread_adjoint`` refuses what the kernel does
  not take (devices, dtypes, shapes, w), with no weights tensor to check
  against.

Both run at kernel widths 4, 7, 14 and 16. The CUDA kernel is held to the
plain version on the card in ``tests/test_torch_adjoint.py`` (marked
``cuda``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fftvis_tpu.nufft.transform import _spread_scatter
from fftvis_tpu_torch.nufft import spread as spread_mod

NF, W, N = (48, 40), 7, 300
BETA = 2.3 * W
WIDTHS = [4, 7, 14, 16]


def _case(C: int, seed: int):
    rng = np.random.default_rng(seed)
    uy, ux = rng.uniform(0, NF[0], N), rng.uniform(0, NF[1], N)
    # Sources on the wrap: their footprints cross the grid's edges.
    uy[:3], ux[:3] = (0.0, 0.4, NF[0] - 0.3), (NF[1] - 0.2, 0.0, 1.1)
    wts = rng.normal(size=(C, N)) + 1j * rng.normal(size=(C, N))
    g = rng.normal(size=(C,) + NF) + 1j * rng.normal(size=(C,) + NF)
    return uy, ux, wts, g


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("C", [1, 4, 40])
def test_spread_adjoint_plain_is_jax_vjp_of_spread_scatter(C, w):
    uy, ux, wts, g = _case(C, 100 + C)
    beta = 2.3 * w

    def forward(x):
        return _spread_scatter([jnp.asarray(uy), jnp.asarray(ux)], x, NF, w, beta)

    _, vjp = jax.vjp(forward, jnp.asarray(wts))
    (want,) = vjp(jnp.asarray(g))
    got = spread_mod.spread_adjoint_plain(torch.tensor(uy), torch.tensor(ux), torch.tensor(g), w,
                                          beta)
    want = np.asarray(want)
    assert got.shape == (C, N)
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("C", [1, 4, 40])
def test_spread_adjoint_dot_product_identity(C, w):
    """<spread c, g> = <c, spread_adjoint g> through the wrappers on the CPU."""
    uy, ux, wts, g = _case(C, 200 + C)
    uyt, uxt, c, gt = (torch.tensor(a) for a in (uy, ux, wts, g))
    Ac = spread_mod.spread(uyt, uxt, c, torch.zeros_like(gt), w, 2.3 * w)
    lhs = torch.vdot(Ac.reshape(-1), gt.reshape(-1)).item()
    rhs = torch.vdot(c.reshape(-1), spread_mod.spread_adjoint(uyt, uxt, gt, w, 2.3 * w)
                     .reshape(-1)).item()
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("case", ["coords dtype", "mixed coords", "grid dtype", "grid dims",
                                  "coords shape", "width", "width 1", "device"])
def test_spread_adjoint_refuses(case):
    uy, ux, _, g = _case(2, 5)
    uyt, uxt, gt, w = torch.tensor(uy), torch.tensor(ux), torch.tensor(g), W
    exc = ValueError
    if case == "coords dtype":
        uyt, exc = uyt.to(torch.int64), TypeError
    elif case == "mixed coords":
        uxt, exc = uxt.to(torch.float32), TypeError
    elif case == "grid dtype":
        gt, exc = gt.to(torch.complex64), TypeError
    elif case == "grid dims":
        gt = gt[0]
    elif case == "coords shape":
        uxt = uxt[:-1]
    elif case == "width":
        w = 17
    elif case == "width 1":
        w = 1
    else:
        gt = gt.to("meta")
    with pytest.raises(exc):
        spread_mod.spread_adjoint(uyt, uxt, gt, w, BETA)
