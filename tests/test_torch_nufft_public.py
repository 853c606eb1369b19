"""The public NUFFT surface of the port (``fftvis_tpu_torch.nufft``) on the
CPU against ``fftvis_tpu.nufft`` and the dense float64 oracles.

- the plan copies: ``plan_type2`` gives the JAX package's arrays (d = 1,
  2, 3);
- every case of ``tests/test_nufft.py``'s ``test_type3_matches_direct``
  (d = 1, 2, 3) and ``test_type1_matches_direct``, and of
  ``tests/test_nufft_type2.py`` (the oracle at d = 1, 2, 3, sigma, the
  transpose identity, duplicate modes, ``point_block``, complex64, the
  dimension mismatch, degenerate points and a bad block, the int32
  refusal, gradients through ``torch.autograd`` against ``jax.grad``), at
  the JAX tests' own tolerances against the oracles;
- the port against the JAX package on the same inputs, each transform at
  d = 1, 2, 3: 1e-12 of max|out| in complex128;
- the plain d = 1 / d = 3 spread against JAX ``_spread_scatter`` and, at d
  = 3, ``_spread_3d_ztaps`` (the TPU's plane scan), and the plain
  interpolation against the JAX executor's gather; gradients through the d
  = 1 / 3 kernels raise, naming ROADMAP item 13;
- the torch direct oracles against the NumPy copies;
- on a CUDA card (marked ``cuda``; skipped without one): the d = 1 and d =
  3 spread and interpolation kernels against their plain versions (1e-5 /
  1e-12 of max|plain|) with their launch counters, and ``make_type{1,2,3}
  _fn`` on the card against the oracles.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fftvis_tpu import nufft as jnufft
from fftvis_tpu.nufft import transform as jax_transform
from fftvis_tpu_torch.nufft import (
    Type2Executor,
    direct_type1,
    direct_type1_np,
    direct_type2,
    direct_type2_np,
    direct_type3,
    direct_type3_np,
    make_type1_fn,
    make_type2_fn,
    make_type3_fn,
    plan_type1,
    plan_type1_exact,
    plan_type2,
    plan_type3,
)
from fftvis_tpu_torch.nufft import interp as interp_mod
from fftvis_tpu_torch.nufft import spread as spread_mod

KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
CDT = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------- the plans

@pytest.mark.parametrize("d", [1, 2, 3])
def test_plan_type2_copy_identical(d):
    rng = np.random.default_rng(d)
    x = rng.uniform(-np.pi, np.pi, (d, 57))
    modes = rng.integers(-12, 13, (d, 40))
    got, want = plan_type2(x, modes, 1e-9), jnufft.plan_type2(x, modes, 1e-9)
    assert (got.d, got.nf, got.n_modes, got.n_points) == (
        want.d, want.nf, want.n_modes, want.n_points)
    assert got.kernel.w == want.kernel.w and got.kernel.beta == want.kernel.beta
    for a, b in zip((got.scatter_idx, got.scatter_deconv, *got.tap_idx, *got.tap_val),
                    (want.scatter_idx, want.scatter_deconv, *want.tap_idx, *want.tap_val)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------- tests/test_nufft.py's cases

def _rand_sources(n, d, rng, extent):
    x = rng.uniform(-1, 1, size=(d, n)) * np.asarray(extent)[:, None]
    c = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    return x, c


def _type3_problem(d):
    rng = np.random.default_rng(42 + d)
    n, m = 400, 150
    extent = [2 * np.pi] * d
    x, c = _rand_sources(n, d, rng, extent)
    smax = 40.0 if d < 3 else 6.0
    s = rng.uniform(0.3, smax, size=(d, m))
    s[0] -= 0.6 * smax
    return x, c, s, extent


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("eps,sigma", [(1e-6, 2.0), (1e-9, 2.0), (1e-12, 2.0), (1e-6, 1.25)])
def test_type3_matches_direct(d, eps, sigma):
    x, c, s, extent = _type3_problem(d)
    got = make_type3_fn(plan_type3(s, extent, eps, sigma), device="cpu")(
        torch.tensor(x), torch.tensor(c)).numpy()
    err = _rel(got, direct_type3_np(x, c, s))
    tol = max({1: 30, 2: 30, 3: 300}[d] * eps, 3e-11)
    assert err < tol, f"d={d} eps={eps} sigma={sigma}: rel err {err:.3e}"


@pytest.mark.parametrize("eps", [1e-6, 1e-10])
def test_type1_matches_direct(eps):
    rng = np.random.default_rng(7)
    n = 300
    x = rng.uniform(0, 2 * np.pi, size=(2, n))
    c = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    modes = rng.integers(-20, 21, size=(2, 77))
    got = make_type1_fn(plan_type1(modes, eps), device="cpu")(
        torch.tensor(x), torch.tensor(c)).numpy()
    assert _rel(got, direct_type1_np(x, c, modes)) < 20 * eps


# ---------------------------------------- tests/test_nufft_type2.py's cases

def _problem(rng, d, n, m_modes, kmax=12):
    x = rng.uniform(-np.pi, np.pi, size=(d, n))
    modes = rng.integers(-kmax, kmax + 1, size=(d, m_modes))
    f = rng.standard_normal((3, m_modes)) + 1j * rng.standard_normal((3, m_modes))
    return x, modes, f


def _type2(plan, f, **kw):
    return make_type2_fn(plan, device="cpu", **kw)(torch.as_tensor(f)).numpy()


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("eps", [1e-4, 1e-7, 1e-11])
def test_type2_matches_dense_oracle(d, eps):
    rng = np.random.default_rng(7 + d)
    x, modes, f = _problem(rng, d, n=57, m_modes=40)
    out = _type2(plan_type2(x, modes, eps), f.astype(np.complex128))
    assert _rel(out, direct_type2_np(x, f, modes)) < 10 * eps


@pytest.mark.parametrize("sigma", [1.25, 2.0])
def test_type2_sigma_variants(sigma):
    rng = np.random.default_rng(3)
    x, modes, f = _problem(rng, 2, n=33, m_modes=25)
    out = _type2(plan_type2(x, modes, 1e-6, upsample_factor=sigma), f.astype(np.complex128))
    assert _rel(out, direct_type2_np(x, f, modes)) < 1e-5


def test_type2_is_type1_transpose():
    """<f, type1(c)> == <type2(f), c> with a plain (non-conjugated) dot."""
    rng = np.random.default_rng(11)
    d, n, m = 2, 41, 30
    x = rng.uniform(-np.pi, np.pi, size=(d, n))
    modes = rng.integers(-10, 11, size=(d, m))
    c = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    f = rng.standard_normal((2, m)) + 1j * rng.standard_normal((2, m))
    t1 = make_type1_fn(plan_type1(modes, 1e-9), device="cpu")(
        torch.tensor(x), torch.tensor(c)).numpy()
    t2 = _type2(plan_type2(x, modes, 1e-9), f)
    lhs, rhs = np.sum(f * t1), np.sum(t2 * c)
    assert abs(lhs - rhs) / abs(lhs) < 1e-11


def test_type2_duplicate_modes_sum():
    rng = np.random.default_rng(5)
    x = rng.uniform(-np.pi, np.pi, size=(1, 19))
    modes = np.array([[3, -2, 3]])  # mode 3 listed twice
    f = np.array([[1.0 + 2.0j, 0.5 - 1.0j, -2.0 + 0.25j]])
    out = _type2(plan_type2(x, modes, 1e-9), f)
    assert _rel(out, direct_type2_np(x, f, modes)) < 1e-8


def test_type2_point_block_equivalence():
    rng = np.random.default_rng(9)
    x, modes, f = _problem(rng, 2, n=101, m_modes=30)
    plan = plan_type2(x, modes, 1e-7)
    full = _type2(plan, f.astype(np.complex128))
    blocked = _type2(plan, f.astype(np.complex128), point_block=17)
    np.testing.assert_allclose(blocked, full, rtol=0, atol=1e-12 * np.abs(full).max())


def test_type2_complex64_pipeline():
    rng = np.random.default_rng(13)
    x, modes, f = _problem(rng, 2, n=29, m_modes=20)
    out = _type2(plan_type2(x, modes, 1e-5), f.astype(np.complex64))
    assert out.dtype == np.complex64
    assert _rel(out, direct_type2_np(x, f, modes)) < 1e-4


def test_type2_dim_mismatch_raises():
    rng = np.random.default_rng(1)
    x = rng.uniform(-np.pi, np.pi, size=(2, 5))
    with pytest.raises(ValueError, match="dims"):
        plan_type2(x, np.zeros((1, 4), dtype=int), 1e-6)


def test_type2_grads_match_jax():
    """The executor's gradient in the mode coefficients (through the
    scatter, the FFT and the interpolation's autograd Function) against
    ``jax.grad`` of the JAX executor and a central difference."""
    rng = np.random.default_rng(21)
    x, modes, f = _problem(rng, 2, n=23, m_modes=15)
    run = make_type2_fn(plan_type2(x, modes, 1e-6), device="cpu")
    jrun = jnufft.make_type2_fn(jnufft.plan_type2(x, modes, 1e-6))

    def jloss(fr):
        return jnp.sum(jnp.abs(jrun(fr + 0j)) ** 2)

    fr = torch.tensor(f.real, requires_grad=True)
    loss = run(fr.to(torch.complex128)).abs().pow(2).sum()
    (g,) = torch.autograd.grad(loss, [fr])
    jg = np.asarray(jax.grad(jloss)(jnp.asarray(f.real)))
    assert _rel(g.numpy(), jg) < 1e-12
    value = float(loss.detach())
    assert abs(value - float(jloss(jnp.asarray(f.real)))) < 1e-12 * value
    e = np.zeros_like(f.real)
    e[1, 3] = 1.0
    h = 1e-5
    with torch.no_grad():
        fd = (float(run(torch.tensor(f.real + h * e + 0j)).abs().pow(2).sum())
              - float(run(torch.tensor(f.real - h * e + 0j)).abs().pow(2).sum())) / (2 * h)
    assert abs(float(g[1, 3]) - fd) < 1e-4 * max(1.0, abs(fd))


def test_type2_degenerate_points_and_bad_block():
    rng = np.random.default_rng(5)
    modes = rng.integers(-6, 7, size=(2, 10))
    f = torch.tensor(rng.standard_normal((3, 10)) + 1j * rng.standard_normal((3, 10)))
    ex = Type2Executor(plan_type2(np.zeros((2, 0)), modes, 1e-6), device="cpu")
    assert tuple(ex.interp(ex.transform(ex.scatter(f))).shape) == (3, 0)
    x = rng.uniform(-np.pi, np.pi, size=(2, 7))
    ex = Type2Executor(plan_type2(x, modes, 1e-6), device="cpu")
    g = ex.transform(ex.scatter(f))
    with pytest.raises(ValueError, match="point_block"):
        ex.interp(g, point_block=0)


def test_plan_rejects_int32_overflowing_grids():
    big = np.array([[1500], [1500], [1500]], dtype=np.int64)
    with pytest.raises(ValueError, match="int32"):
        plan_type1(big, eps=1e-6)
    huge = np.array([[70000], [70000], [70000]], dtype=np.int64)
    with pytest.raises(ValueError, match="int32"):
        plan_type1_exact(huge)


# ------------------------------------------------- the port against JAX

@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("kind", ["type1", "type2", "type3"])
def test_transform_matches_jax(kind, d):
    """One input through both packages' public functions, complex128."""
    rng = np.random.default_rng(100 + d)
    eps = 1e-9
    if kind == "type3":
        x, c, s, extent = _type3_problem(d)
        got = make_type3_fn(plan_type3(s, extent, eps), device="cpu")(
            torch.tensor(x), torch.tensor(c)).numpy()
        want = jnufft.make_type3_fn(jnufft.plan_type3(s, extent, eps))(
            jnp.asarray(x), jnp.asarray(c))
    elif kind == "type1":
        x, c = _rand_sources(300, d, rng, [np.pi] * d)
        modes = rng.integers(-15, 16, size=(d, 50))
        got = make_type1_fn(plan_type1(modes, eps), device="cpu")(
            torch.tensor(x), torch.tensor(c)).numpy()
        want = jnufft.make_type1_fn(jnufft.plan_type1(modes, eps))(jnp.asarray(x),
                                                                   jnp.asarray(c))
    else:
        x, modes, f = _problem(rng, d, n=120, m_modes=50)
        got = _type2(plan_type2(x, modes, eps), f)
        want = jnufft.make_type2_fn(jnufft.plan_type2(x, modes, eps))(jnp.asarray(f))
    assert got.dtype == np.complex128
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("w", [5, 8])
def test_plain_spread_matches_jax_spreaders(d, w):
    """The plain d = 1 / 3 spread (the kernels' CPU version) against the
    JAX scatter spreader and, at d = 3, its z-plane scan."""
    rng = np.random.default_rng(w + d)
    nf = (40,) if d == 1 else (24, 20, 16)
    n, beta = 200, 2.3 * w
    u = [rng.uniform(0, m, n) for m in nf]
    u[0][:2] = (nf[0], 0.0)  # a coordinate at the wrap edge
    wts = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    grid = torch.zeros((3,) + nf, dtype=torch.complex128)
    got = spread_mod.spread_nd([torch.tensor(a) for a in u], torch.tensor(wts), grid, w, beta)
    ju = [jnp.asarray(a) for a in u]
    want = np.asarray(jax_transform._spread_scatter(ju, jnp.asarray(wts), nf, w, beta))
    assert _rel(got.numpy(), want) <= 1e-13
    if d == 3:
        scan = np.asarray(jax_transform._spread_3d_ztaps(ju, jnp.asarray(wts), nf, w, beta))
        assert _rel(got.numpy(), scan) <= 1e-12


@pytest.mark.parametrize("d", [1, 3])
def test_plain_interp_matches_jax_executor(d):
    x, c, s, extent = _type3_problem(d)
    plan = plan_type3(s, extent, 1e-9)
    G = np.random.default_rng(d).normal(size=(2,) + plan.nf) + 0j
    got = interp_mod.interp_nd(
        torch.tensor(G), [torch.tensor(a, dtype=torch.int32) for a in plan.tap_idx],
        [torch.tensor(a) for a in plan.tap_val]).numpy()
    want = jax_transform.Type3Executor(jnufft.plan_type3(s, extent, 1e-9)).interpolate(
        jnp.asarray(G))
    assert _rel(got, want) <= 1e-13


@pytest.mark.parametrize("d", [1, 3])
def test_nd_gradients_raise(d):
    x, c, s, extent = _type3_problem(d)
    run = make_type3_fn(plan_type3(s, extent, 1e-6), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        run(torch.tensor(x), torch.tensor(c).requires_grad_())


def test_torch_direct_oracles_match_numpy():
    rng = np.random.default_rng(2)
    x = rng.uniform(-np.pi, np.pi, (3, 70))
    c = rng.normal(size=(2, 70)) + 1j * rng.normal(size=(2, 70))
    modes = rng.integers(-9, 10, (3, 30))
    f = rng.normal(size=(2, 30)) + 1j * rng.normal(size=(2, 30))
    s = rng.uniform(-20, 20, (3, 25))
    tx = torch.tensor(x)
    assert _rel(direct_type1(tx, torch.tensor(c), modes, 16).numpy(),
                direct_type1_np(x, c, modes)) < 1e-13
    assert _rel(direct_type2(tx, torch.tensor(f), modes, 16).numpy(),
                direct_type2_np(x, f, modes)) < 1e-13
    assert _rel(direct_type3(tx, torch.tensor(c), s).numpy(), direct_type3_np(x, c, s)) < 1e-13
    assert _rel(direct_type3_np(x, c, s), jnufft.direct_type3_np(x, c, s)) == 0


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 3])
def test_cuda_nd_kernels_match_plain(cuda_device, d, dtype):
    rng = np.random.default_rng(d)
    nf = (1000,) if d == 1 else (40, 36, 24)
    w = 7 if dtype == torch.float32 else 14
    beta, n, C = 2.3 * w, 3000, 3
    u = [rng.uniform(0, m, n) for m in nf]
    u[0][:2] = (nf[0], 0.0)
    wts = rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
    wts[:, ::3] = 0  # sources the kernel skips
    ut = [torch.tensor(a, dtype=dtype, device=cuda_device) for a in u]
    wt = torch.tensor(wts, dtype=CDT[dtype], device=cuda_device)
    counter = f"launches_d{d}"
    before = getattr(spread_mod, counter)
    got = spread_mod.spread_nd(ut, wt, torch.zeros((C,) + nf, dtype=CDT[dtype],
                                                   device=cuda_device), w, beta)
    want = spread_mod.spread_nd_plain(ut, wt, torch.zeros_like(got), w, beta)
    torch.cuda.synchronize()
    assert getattr(spread_mod, counter) == before + 1
    assert (got - want).abs().max().item() <= KERNEL_TOL[dtype] * want.abs().max().item()

    m = 2500
    idx = [torch.tensor(rng.integers(0, k, (m, w)), dtype=torch.int32, device=cuda_device)
           for k in nf]
    val = [torch.tensor(rng.uniform(0, 1, (m, w)), dtype=dtype, device=cuda_device)
           for _ in nf]
    G = torch.tensor(rng.normal(size=(C,) + nf) + 1j * rng.normal(size=(C,) + nf),
                     dtype=CDT[dtype], device=cuda_device)
    before = getattr(interp_mod, counter)
    got = interp_mod.interp_nd(G, idx, val)
    want = interp_mod.interp_nd_plain(G, idx, val)
    torch.cuda.synchronize()
    assert getattr(interp_mod, counter) == before + 1
    assert (got - want).abs().max().item() <= KERNEL_TOL[dtype] * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3])
def test_cuda_public_transforms_match_oracles(cuda_device, d):
    x, c, s, extent = _type3_problem(d)
    tx, tc = (torch.tensor(a, device=cuda_device) for a in (x, c))
    got = make_type3_fn(plan_type3(s, extent, 1e-9))(tx, tc).cpu().numpy()
    assert _rel(got, direct_type3_np(x, c, s)) < max({1: 30, 2: 30, 3: 300}[d] * 1e-9, 3e-11)
    rng = np.random.default_rng(d)
    modes = rng.integers(-12, 13, (d, 40))
    got = make_type1_fn(plan_type1(modes, 1e-9))(tx, tc).cpu().numpy()
    assert _rel(got, direct_type1_np(x, c, modes)) < 20 * 1e-9
    f = rng.normal(size=(3, 40)) + 1j * rng.normal(size=(3, 40))
    got = make_type2_fn(plan_type2(x, modes, 1e-9))(torch.tensor(f, device=cuda_device))
    assert _rel(got.cpu().numpy(), direct_type2_np(x, f, modes)) < 10 * 1e-9
