"""The port's tabulated-beam host code and prepared beams vs the JAX package.

- ``GriddedBeam``, ``read_beamfits`` on the committed asset,
  ``structured_dipole_beam`` and ``perturbed_variants`` are NumPy copies:
  their arrays must equal the originals';
- analytic ``efield`` matches the JAX beams to rounding (1e-12);
- ``prepare_beam(...).evaluate`` of efield and power beams, orders 1 and 3,
  at two simulation frequencies between the table's, matches the JAX
  prepared beam: 1e-12 of the peak in float64 (one algorithm; the float64
  points keep za inside the table, away from the JAX order-1 edge clip), 1e-5
  in float32 (the JAX package interpolates a float64 table at float32
  coordinates, the port a float32 table);
- the preparation rules: spline orders, the za-domain check, feed selection.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fftvis_tpu.beams import analytic as jax_analytic
from fftvis_tpu.beams import gridded as jax_gridded
from fftvis_tpu.beams import interface as jax_interface
from fftvis_tpu.beams import io as jax_io
from fftvis_tpu.beams import synth as jax_synth
from fftvis_tpu_torch.beams import (
    AiryBeam,
    GaussianBeam,
    GriddedBeam,
    ShortDipoleBeam,
    UniformBeam,
    beam_from_reference,
    perturbed_variants,
    prepare_beam,
    prepare_beam_unpolarized,
    read_beamfits,
    structured_dipole_beam,
)
from fftvis_tpu_torch.beams import interface as port_interface
from fftvis_tpu_torch.beams import synth as port_synth

ASSET = Path(__file__).resolve().parent / "data" / "structured_dipole_100MHz.beamfits"


def _same(a, b):
    assert type(a).__name__ == type(b).__name__ == "GriddedBeam"
    for name in ("data_array", "axis1_array", "axis2_array", "freq_array"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.beam_type == b.beam_type and a.feeds == b.feeds
    assert a.az_wraps == b.az_wraps


def _two_freq_beam(mod):
    """A two-frequency efield table built from two structured variants."""
    b0 = mod.structured_dipole_beam(n_az=48, n_za=19, variant=0, dtype=np.complex128)
    b1 = mod.structured_dipole_beam(n_az=48, n_za=19, variant=1, dtype=np.complex128)
    data = np.concatenate([b0.data_array, b1.data_array], axis=2)
    return mod.GriddedBeam(data, b0.axis1_array, b0.axis2_array, [1.0e8, 1.2e8],
                           "efield", feeds=["x", "y"])


def test_read_beamfits_equals_reference():
    _same(read_beamfits(str(ASSET)), jax_io.read_beamfits(str(ASSET)))


@pytest.mark.parametrize("variant", [0, 2])
def test_structured_dipole_and_variants_equal_reference(variant):
    got = structured_dipole_beam(n_az=72, n_za=31, variant=variant)
    want = jax_synth.structured_dipole_beam(n_az=72, n_za=31, variant=variant)
    _same(got, want)
    for a, b in zip(perturbed_variants(got, 3), jax_synth.perturbed_variants(want, 3)):
        _same(a, b)


def test_gridded_beam_transforms_equal_reference():
    got, want = _two_freq_beam(port_synth), _two_freq_beam(jax_synth)
    _same(got, want)
    freqs = np.array([1.05e8, 1.15e8, 1.2e8])
    _same(got.interp_freq(freqs), want.interp_freq(freqs))
    _same(got.as_power_beam(), want.as_power_beam())
    _same(got.interp_freq(freqs).as_power_beam(), want.interp_freq(freqs).as_power_beam())
    with pytest.raises(ValueError, match="outside"):
        got.interp_freq([2e8])


def test_gridded_beam_seam_endpoint_is_dropped():
    az = np.linspace(0, 2 * np.pi, 13)  # closed grid: 0 and 2pi both present
    za = np.linspace(0, np.pi / 2, 5)
    data = np.random.default_rng(0).normal(size=(1, 2, 1, 5, 13))
    got = GriddedBeam(data, az, za, [1e8], "power")
    want = jax_gridded.GriddedBeam(data, az, za, [1e8], "power")
    _same(got, want)
    assert got.data_array.shape[-1] == 12 and got.az_wraps


@pytest.mark.parametrize("xorient,feeds", [("east", ["x", "y"]), ("north", ["x", "y"]),
                                           ("east", ["y", "x"]), (None, ["e", "n"])])
def test_from_uvbeam_equals_reference(xorient, feeds):
    rng = np.random.default_rng(1)

    class UV:
        data_array = rng.normal(size=(2, 1, 2, 1, 5, 8)) + 0j
        axis1_array = np.linspace(0, 2 * np.pi, 8, endpoint=False)
        axis2_array = np.linspace(0, np.pi / 2, 5)
        freq_array = np.array([[1e8]])
        beam_type = "efield"
        feed_array = np.array(feeds)
        x_orientation = xorient

    _same(GriddedBeam.from_uvbeam(UV), jax_gridded.GriddedBeam.from_uvbeam(UV))


def test_analytic_efield_matches_reference():
    rng = np.random.default_rng(2)
    az, za = rng.uniform(0, 2 * np.pi, 300), rng.uniform(0, np.pi / 2, 300)
    pairs = ((GaussianBeam(diameter=14.0), jax_analytic.GaussianBeam(diameter=14.0)),
             (AiryBeam(diameter=14.0), jax_analytic.AiryBeam(diameter=14.0)),
             (UniformBeam(), jax_analytic.UniformBeam()),
             (ShortDipoleBeam(), jax_analytic.ShortDipoleBeam()))
    for beam, jbeam in pairs:
        got = beam.efield(torch.tensor(az), torch.tensor(za), 1.1e8).numpy()
        want = np.asarray(jbeam.efield(jnp.asarray(az), jnp.asarray(za), 1.1e8))
        assert got.shape == want.shape == (2, 2, 300)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
        assert type(beam_from_reference(jbeam)) is type(beam)
    got = ShortDipoleBeam().power(torch.tensor(az), torch.tensor(za), 1e8, feed="y").numpy()
    want = np.asarray(jax_analytic.ShortDipoleBeam().power(jnp.asarray(az), jnp.asarray(za),
                                                           1e8, feed="y"))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_from_function_and_beam_from_reference():
    got = GriddedBeam.from_function(AiryBeam(diameter=12.0), n_az=24, n_za=13, freqs=(1e8,))
    want = jax_gridded.GriddedBeam.from_function(jax_analytic.AiryBeam(diameter=12.0),
                                                 n_az=24, n_za=13, freqs=(1e8,))
    np.testing.assert_allclose(got.data_array, want.data_array, rtol=1e-12, atol=1e-15)
    _same(beam_from_reference(want), want)


def _points(n, seed, dtype):
    rng = np.random.default_rng(seed)
    az = rng.uniform(0, 2 * np.pi, n)
    za = rng.uniform(0, np.pi / 2 - 1e-3, n)
    az[:4] = [0.0, 2 * np.pi - 1e-9, np.pi, 1e-12]  # on and next to the seam
    return az.astype(dtype), za.astype(dtype)


@pytest.mark.parametrize("precision", [2, 1])
@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("polarized", [True, False])
def test_prepared_tabulated_beam_matches_reference(polarized, order, precision):
    freqs = np.array([1.05e8, 1.15e8])
    opts = {"order": order}
    rdt = {2: np.float64, 1: np.float32}[precision]
    beam = _two_freq_beam(port_synth)
    jbeam = _two_freq_beam(jax_synth)
    if not polarized:
        beam = prepare_beam_unpolarized(beam, use_feed="y")
        jbeam = jax_interface.prepare_beam_unpolarized(jbeam, use_feed="y")
    pb = prepare_beam(beam, freqs, polarized, spline_opts=opts,
                      dtype=torch.float64 if precision == 2 else torch.float32, device="cpu")
    jpb = jax_interface.prepare_beam(jbeam, freqs, polarized, spline_opts=opts)
    assert pb.polarized == jpb.polarized == polarized
    az, za = _points(500, seed=order, dtype=rdt)
    tol = {2: 1e-12, 1: 1e-5}[precision]
    for fi, fv in enumerate(freqs):
        got = pb.evaluate(torch.from_numpy(az), torch.from_numpy(za), fv, fi).numpy()
        want = np.asarray(jpb.evaluate(jnp.asarray(az), jnp.asarray(za), fv, fi))
        assert got.shape == want.shape == ((2, 2, 500) if polarized else (500,))
        np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("polarized", [True, False])
def test_prepared_analytic_beam_matches_reference(polarized):
    az, za = _points(200, seed=3, dtype=np.float64)
    pb = prepare_beam(ShortDipoleBeam(), [1e8], polarized, use_feed="y", device="cpu")
    jpb = jax_interface.prepare_beam(jax_analytic.ShortDipoleBeam(), np.array([1e8]),
                                     polarized, use_feed="y")
    got = pb.evaluate(torch.from_numpy(az), torch.from_numpy(za), 1e8, 0).numpy()
    want = np.asarray(jpb.evaluate(jnp.asarray(az), jnp.asarray(za), 1e8, 0))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("opts,fn,order", [
    ({"order": 3}, "az_za_map_coordinates", 3),
    (None, "az_za_map_coordinates", 1),
    ({"kx": 3, "ky": 3}, "az_za_map_coordinates", 3),
    (None, "az_za_simple", 3),
    ({"order": 1}, "az_za_simple", 1),
])
def test_spline_order_rules(opts, fn, order):
    assert port_interface._spline_order(opts, fn) == order


@pytest.mark.parametrize("opts,fn", [({"order": 2}, "az_za_map_coordinates"),
                                     ({"kx": 1, "ky": 3}, "az_za_map_coordinates"),
                                     (None, "nearest")])
def test_spline_order_rules_refuse(opts, fn):
    with pytest.raises(ValueError):
        port_interface._spline_order(opts, fn)


def test_za_domain_check_and_clamp_opt_in(monkeypatch):
    short = structured_dipole_beam(n_az=24, n_za=10)
    beam = GriddedBeam(short.data_array, short.axis1_array, short.axis2_array * 0.5,
                       short.freq_array, "efield", feeds=["x", "y"])
    monkeypatch.delenv("FFTVIS_ALLOW_BEAM_CLAMP", raising=False)
    with pytest.raises(ValueError, match="check_azza_domain"):
        prepare_beam(beam, [1e8], True, device="cpu")
    monkeypatch.setenv("FFTVIS_ALLOW_BEAM_CLAMP", "1")
    assert prepare_beam(beam, [1e8], True, device="cpu").polarized


def test_feed_selection():
    beam = structured_dipole_beam(n_az=24, n_za=10, dtype=np.complex128)
    power = beam.as_power_beam()
    az, za = (torch.from_numpy(a) for a in _points(50, seed=4, dtype=np.float64))
    for feed, idx in (("x", 0), ("y", 1)):
        pb = prepare_beam(prepare_beam_unpolarized(beam, use_feed=feed), [1e8], False,
                          device="cpu")
        one = GriddedBeam(power.data_array[:, idx:idx + 1], power.axis1_array,
                          power.axis2_array, power.freq_array, "power")
        want = prepare_beam(one, [1e8], False, device="cpu")
        np.testing.assert_allclose(pb.evaluate(az, za, 1e8, 0).numpy(),
                                   want.evaluate(az, za, 1e8, 0).numpy(), rtol=1e-14)
    single = GriddedBeam(power.data_array[:, :1], power.axis1_array, power.axis2_array,
                         power.freq_array, "power", feeds=["x"])
    with pytest.raises(ValueError, match="not present"):
        prepare_beam(prepare_beam_unpolarized(single, use_feed="y"), [1e8], False,
                     device="cpu")
    with pytest.raises(ValueError, match="efield"):
        prepare_beam(power, [1e8], True, device="cpu")
