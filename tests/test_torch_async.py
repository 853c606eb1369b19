"""``async_fetch`` and :class:`VisibilityFuture` of the port.

The JAX package's future tests (``tests/test_wrapper.py``,
``tests/test_batched_paths.py``) on the port, at their small sizes, with
the same seeded inputs through ``fftvis_tpu`` beside them: the port agrees
with it within 1e-9 of max|V| (precision=2; both sides with
``FFTVIS_AUTO_RANK=0``). On the CPU a future comes back resolved; the
future's own mechanics (the lock, the release after ``result()``, ``done()``
against a concurrent ``result()``) are held on a pending future built by
hand around a stand-in event. On a CUDA card (marked ``cuda``; skipped
without one) a future comes back pending, its result equals the
synchronous call's within 1e-12 / 1e-5 of max|V| at precision 2 / 1, and a
warm dispatch makes the host wait for the card nowhere.
"""

import sys
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from fftvis_tpu import TelescopeLocation as JaxLocation
from fftvis_tpu import simulate_vis as jax_simulate_vis
from fftvis_tpu.beams import GaussianBeam as JaxGaussian
from fftvis_tpu.beams import GriddedBeam as JaxGridded
from fftvis_tpu_torch import (
    TelescopeLocation,
    VisibilityFuture,
    compute_beam_basis,
    simulate_vis,
)
from fftvis_tpu_torch.beams import GaussianBeam, GriddedBeam
from fftvis_tpu_torch.cuda import engine as engine_mod

SITE = (np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JD0 = 2459863.2
FREQS = np.array([1.0e8, 1.17e8])
VS_REFERENCE = 1e-9
ORDER_TOL = {2: 1e-12, 1: 1e-5}


@pytest.fixture(autouse=True)
def _pair_routing_on_both_sides(monkeypatch):
    monkeypatch.setenv("FFTVIS_AUTO_RANK", "0")


def _kwargs(rng, nant=4, nsrc=12, nfreq=2, ntimes=2, **over):
    """(port kwargs, fftvis_tpu kwargs) of one small random configuration
    (the JAX package's ``test_wrapper._kwargs``)."""
    ants = {i: np.array([*rng.uniform(-40, 40, 2), 0.0]) for i in range(nant)}
    kw = dict(
        ants=ants,
        fluxes=rng.uniform(0.1, 1, (nsrc, nfreq)),
        ra=rng.uniform(0, 2 * np.pi, nsrc),
        dec=np.clip(SITE[0] + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2),
        freqs=np.linspace(1e8, 1.2e8, nfreq),
        times=JD0 + np.linspace(0, 0.01, ntimes),
    )
    kw.update(over)
    port = dict(kw, beam=GaussianBeam(diameter=10.0), telescope_loc=TelescopeLocation(*SITE),
                device="cpu")
    jax = dict(kw, beam=JaxGaussian(diameter=10.0), telescope_loc=JaxLocation(*SITE))
    return port, jax


def _vs_reference(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() / np.abs(want).max() <= VS_REFERENCE


def test_async_fetch_matches_sync():
    """async_fetch=True returns a VisibilityFuture resolving to the
    synchronous result; several futures resolve independently and
    np.asarray(future) works."""
    kw, jkw = _kwargs(np.random.default_rng(3))
    want = simulate_vis(**kw, polarized=True)
    futs = [simulate_vis(**kw, polarized=True, async_fetch=True) for _ in range(3)]
    assert all(isinstance(f, VisibilityFuture) for f in futs)
    for f in futs:
        got = f.result()
        np.testing.assert_array_equal(got, want)
        assert f.result() is got  # memoized
        assert f.done()
    np.testing.assert_array_equal(np.asarray(futs[0]), want)
    _vs_reference(want, jax_simulate_vis(**jkw, polarized=True, async_fetch=True).result())


def test_future_array_copy_semantics():
    """np.array(fut, copy=True) must not alias the memoized result, and
    copy=False with a dtype conversion must refuse."""
    kw, _ = _kwargs(np.random.default_rng(7))
    fut = simulate_vis(**kw, async_fetch=True)
    res = fut.result()
    a = fut.__array__(copy=True)
    assert a is not res
    a *= 2.0
    np.testing.assert_array_equal(fut.result(), res)
    assert fut.__array__() is res  # plain asarray may share
    assert fut.__array__(dtype=np.complex64).dtype == np.complex64
    with pytest.raises(ValueError, match="copy"):
        fut.__array__(dtype=np.complex64, copy=False)


def test_async_fetch_snapshots_inputs():
    """Every user array the call reads is consumed at dispatch: mutating
    them in place before result() leaves the result as it was (the JAX
    package's beam_coefs snapshot test, on the other inputs;
    ``test_async_fetch_snapshots_beam_coefs`` has beam_coefs)."""
    kw, jkw = _kwargs(np.random.default_rng(9))
    want = simulate_vis(**{k: (v.copy() if isinstance(v, np.ndarray) else v)
                           for k, v in kw.items()})
    _vs_reference(want, jax_simulate_vis(**jkw))
    fut = simulate_vis(**kw, async_fetch=True)
    for name in ("fluxes", "ra", "dec", "freqs", "times"):
        kw[name] *= 0.5
    kw["ants"][1][:] = 0.0
    np.testing.assert_array_equal(fut.result(), want)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_async_fetch_snapshots_beam_coefs(device):
    """An eigenbeam call's coefficients go to the device at dispatch: a
    caller that changes its ``beam_coefs`` in place for the next call while
    a future is in flight does not change the in-flight result (the JAX
    package's snapshot of beam_coefs)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw, _ = _kwargs(np.random.default_rng(11), nant=5, nsrc=36, nfreq=1)
    eig, coefs = compute_beam_basis([_gridded(11.0 + 0.4 * i)[0] for i in range(3)], 1.0e8,
                                    True)
    coefs = coefs[np.arange(5) % 3][:, :, None]
    kw.update(beam=eig, polarized=True, device=device)
    want = simulate_vis(beam_coefs=coefs.copy(), **kw)
    live = coefs.copy()
    fut = simulate_vis(beam_coefs=live, async_fetch=True, **kw)
    live *= 0.5
    np.testing.assert_allclose(fut.result(), want, rtol=0,
                               atol=ORDER_TOL[2] * np.abs(want).max())
    assert not np.allclose(simulate_vis(beam_coefs=live, **kw), want)


def test_async_fetch_immune_to_flux_mutation_after_dispatch():
    """A caller that reuses its flux buffer for the next sweep step while
    a future is in flight does not corrupt the in-flight result."""
    kw, _ = _kwargs(np.random.default_rng(8), nant=5, nsrc=36)
    flux = kw.pop("fluxes")
    want = simulate_vis(fluxes=flux.copy(), **kw)
    live = flux.copy()
    fut = simulate_vis(fluxes=live, async_fetch=True, **kw)
    live[:] = -999.0
    np.testing.assert_allclose(fut.result(), want, atol=1e-12 * np.abs(want).max(), rtol=0)


def _gridded(diameter):
    """(port, fftvis_tpu) tabulations of one Gaussian beam on one grid."""
    jb = JaxGridded.from_function(JaxGaussian(diameter=diameter), n_az=90, n_za=46,
                                  freqs=FREQS, za_max=np.pi / 2)
    return GriddedBeam(jb.data_array, jb.axis1_array, jb.axis2_array, jb.freq_array,
                       jb.beam_type, feeds=jb.feeds), jb


@pytest.mark.parametrize("per_antenna", [False, True], ids=["shared", "per-antenna"])
def test_freq_stacked_sweep_equals_separate_sims(per_antenna):
    """A sweep batched by stacking per-simulation flux columns on a tiled
    frequency axis equals the separate calls, shared-beam unpolarized and
    per-antenna polarized (pair routing, flips, the beams' frequency
    interpolation), and the JAX package's answer."""
    rng = np.random.default_rng(7 if per_antenna else 6)
    kw, jkw = _kwargs(rng, nant=5, nsrc=36, freqs=np.linspace(1.0e8, 1.1e8, 2))
    if per_antenna:
        beams = [_gridded(11.0 + 0.4 * i) for i in range(5)]
        kw.update(beam=[b[0] for b in beams], beam_idx=np.arange(5), polarized=True)
        jkw.update(beam=[b[1] for b in beams], beam_idx=np.arange(5), polarized=True)
    freqs = kw.pop("freqs")
    flux_a = kw.pop("fluxes")
    flux_b = rng.uniform(0.1, 1.0, flux_a.shape)
    va = simulate_vis(freqs=freqs, fluxes=flux_a, **kw)
    vb = simulate_vis(freqs=freqs, fluxes=flux_b, **kw)
    stacked = dict(freqs=np.concatenate([freqs, freqs]),
                   fluxes=np.concatenate([flux_a, flux_b], axis=1))
    v = simulate_vis(**stacked, async_fetch=True, **kw).result()
    scale = np.abs(va).max()
    np.testing.assert_allclose(v[: freqs.size], va, atol=1e-11 * scale, rtol=0)
    np.testing.assert_allclose(v[freqs.size:], vb, atol=1e-11 * scale, rtol=0)
    jkw = {k: val for k, val in jkw.items() if k not in ("freqs", "fluxes")}
    _vs_reference(v, jax_simulate_vis(**stacked, **jkw))


def test_many_futures_resolve_from_threads():
    """Several futures collected concurrently each resolve to the
    synchronous result."""
    rng = np.random.default_rng(9)
    kw, _ = _kwargs(rng, nant=5, nsrc=36)
    flux = kw.pop("fluxes")
    fluxes = [rng.uniform(0.1, 1.0, flux.shape) for _ in range(4)]
    want = [simulate_vis(fluxes=f, **kw) for f in fluxes]
    futs = [simulate_vis(fluxes=f, async_fetch=True, **kw) for f in fluxes]
    with ThreadPoolExecutor(2) as pool:
        got = list(pool.map(lambda f: f.result(), futs))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_same_future_resolved_from_two_threads():
    kw, _ = _kwargs(np.random.default_rng(10), nant=5, nsrc=36)
    want = simulate_vis(**kw)
    fut = simulate_vis(async_fetch=True, **kw)
    with ThreadPoolExecutor(2) as pool:
        a, b = list(pool.map(lambda f: f.result(), [fut, fut]))
    assert a is b
    np.testing.assert_array_equal(a, want)


# ------------------------------------------------------ a pending future

class _Event:
    """Stands in for a torch.cuda.Event: set by the test."""

    def __init__(self):
        self._set = threading.Event()
        self.waits = 0

    def query(self):
        return self._set.is_set()

    def synchronize(self):
        self.waits += 1
        assert self._set.wait(10)

    def set(self):
        self._set.set()


def _pending(assembled):
    """A pending future over a CPU 'device output' and 'pinned' copy, whose
    assembly counts its calls in ``assembled`` and takes a while."""
    dev = torch.arange(12, dtype=torch.float64).to(torch.complex128).reshape(1, 1, 1, 1, 12)
    host = dev.clone()

    def assemble(arr):
        assembled.append(1)
        time.sleep(0.02)
        return engine_mod.assemble_output(arr, polarized=False)

    return VisibilityFuture(dev, host, _Event(), assemble)


def test_future_releases_assembly_after_result():
    """result() drops the device output, the host buffer, the event and the
    assembly closure, and done() is True afterwards."""
    assembled = []
    fut = _pending(assembled)
    assert not fut.done()
    fut._event.set()
    assert fut.done()
    res = fut.result()
    assert fut._dev is None and fut._host is None and fut._event is None
    assert fut._assemble is None
    assert fut.done() and fut.result() is res and len(assembled) == 1
    np.testing.assert_array_equal(res, np.arange(12, dtype=np.complex128)[None, None])
    kw, _ = _kwargs(np.random.default_rng(10))
    resolved = simulate_vis(**kw, async_fetch=True)  # a CPU device: resolved at once
    assert resolved.done() and resolved._assemble is None and resolved._event is None


def test_pending_future_assembles_once_across_threads():
    """Two collectors on one pending future: one assembles, both get its
    array."""
    assembled = []
    fut = _pending(assembled)
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(fut.result) for _ in range(2)]
        time.sleep(0.01)
        fut._event.set()
        a, b = (r.result(timeout=10) for r in runs)
    assert a is b and len(assembled) == 1


class _DropsEventOnRead(VisibilityFuture):
    """A future whose event is dropped right after each read of it, as a
    concurrent result() may drop it between two reads."""

    @property
    def _event(self):
        event, self._ev = self._ev, None
        return event

    @_event.setter
    def _event(self, event):
        self._ev = event


def test_done_reads_the_event_once():
    """done() must not read the event twice: result() in another thread may
    drop it in between (the JAX package's done() once failed so)."""
    event = _Event()
    event.set()
    fut = _DropsEventOnRead(None, None, event, None)
    assert fut.done()


def test_done_races_result():
    """done() polled from many threads while another resolves the future
    never fails and ends True (done() once read the handle that result()
    was dropping)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            assembled, errors = [], []
            fut = _pending(assembled)
            stop = threading.Event()

            def poll():
                try:
                    while not stop.is_set():
                        fut.done()
                except Exception as exc:  # the failure this test looks for
                    errors.append(exc)

            pollers = [threading.Thread(target=poll) for _ in range(12)]
            for t in pollers:
                t.start()
            fut._event.set()
            fut.result()
            stop.set()
            for t in pollers:
                t.join(timeout=10)
            assert not any(t.is_alive() for t in pollers)
            assert errors == [] and fut.done() and len(assembled) == 1
    finally:
        sys.setswitchinterval(old)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [2, 1])
def test_cuda_async_matches_sync(cuda_device, precision):
    """On the card a future comes back pending (nothing resolves quietly),
    done() turns true, and each of several in-flight futures equals the
    synchronous result."""
    kw, _ = _kwargs(np.random.default_rng(3), nant=5, nsrc=36)
    kw.update(device="cuda", precision=precision, polarized=True)
    want = simulate_vis(**kw)
    futs = [simulate_vis(**kw, async_fetch=True) for _ in range(3)]
    assert all(f._result is None and f._event is not None for f in futs)
    for f in futs:
        got = f.result()
        assert f.done() and f._dev is None and f.result() is got
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ORDER_TOL[precision] * np.abs(want).max())
    deadline = time.monotonic() + 10
    late = simulate_vis(**kw, async_fetch=True)
    while not late.done():
        assert time.monotonic() < deadline
        time.sleep(1e-3)
    np.testing.assert_allclose(late.result(), want, rtol=0,
                               atol=ORDER_TOL[precision] * np.abs(want).max())


@pytest.mark.cuda
def test_cuda_warm_dispatch_does_not_wait_for_the_card(cuda_device):
    """A warm asynchronous call makes no synchronizing CUDA call between
    dispatch and result()."""
    kw, _ = _kwargs(np.random.default_rng(4), nant=5, nsrc=36)
    kw.update(device="cuda", polarized=True)
    simulate_vis(**kw)  # cold: plans, prepares and uploads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fut = simulate_vis(**kw, async_fetch=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert syncs == [], [str(w.message) for w in syncs]
    assert np.all(np.isfinite(fut.result()))
