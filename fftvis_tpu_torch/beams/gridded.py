"""Gridded (tabulated) beams on a regular (az, za) grid.

A NumPy copy of ``fftvis_tpu/beams/gridded.py``: an E-field or power beam
sampled on a regular azimuth/zenith-angle grid, in pyuvdata's UVBeam layout
``data_array[Naxes_vec, Nfeeds, Nfreqs, Nza, Naz]``, with frequency
interpolation and E-field -> power conversion at setup time. The only
change is :meth:`GriddedBeam.from_function`, which tabulates through the
port's tensor ``efield``. The tests hold every array to the original's.
"""

from __future__ import annotations

import numpy as np
import torch


class GriddedBeam:
    """An E-field or power beam tabulated on a regular (az, za) grid.

    Parameters
    ----------
    data_array
        ``(Naxes_vec, Nfeeds, Nfreqs, Nza, Naz)`` complex (efield) or
        ``(1, Npols, Nfreqs, Nza, Naz)`` real (power).
    axis1_array
        Azimuth samples (radians), uniformly spaced. UVBeam az convention
        (east = 0, CCW toward north).
    axis2_array
        Zenith-angle samples (radians), uniformly spaced, ascending from 0.
    freq_array
        Frequencies (Hz), ascending.
    beam_type
        "efield" or "power".
    feeds
        Optional feed labels for the feed axis (e.g. ``["x", "y"]``,
        lowercase, east-first convention). When present, ``use_feed``
        requests resolve by label and a missing feed raises.
    """

    pixel_coordinate_system = "az_za"

    def __init__(self, data_array, axis1_array, axis2_array, freq_array,
                 beam_type="efield", feeds=None):
        arr = np.asarray(data_array)
        ax1 = np.atleast_1d(np.asarray(axis1_array, dtype=float))
        # A grid carrying both az=0 and az=2pi holds a duplicated seam
        # column; periodic indexing would then use period naz*daz =
        # 2pi + daz. Drop the endpoint.
        if ax1.size >= 2 and abs((ax1[-1] - ax1[0]) - 2 * np.pi) < 1e-8:
            ax1 = ax1[:-1]
            arr = arr[..., :-1]
        # The table is immutable by contract (every transform returns a new
        # GriddedBeam); a writable caller array is copied, never frozen in
        # place.
        if arr.flags.writeable:
            if arr is data_array or arr.base is not None:
                arr = arr.copy()
            arr.setflags(write=False)
        self.data_array = arr

        def _own_frozen(orig):
            a = np.atleast_1d(np.asarray(orig, dtype=float))
            if a.flags.writeable:
                if a is orig or a.base is not None:
                    a = a.copy()
                a.setflags(write=False)
            return a

        self.axis1_array = _own_frozen(ax1)
        self.axis2_array = _own_frozen(axis2_array)
        self.freq_array = _own_frozen(freq_array)
        self.beam_type = beam_type
        self.feeds = None if feeds is None else [str(f).lower() for f in feeds]
        if self.feeds is not None and len(self.feeds) != self.data_array.shape[1]:
            raise ValueError(
                f"feeds {self.feeds} does not match the feed axis "
                f"({self.data_array.shape[1]})"
            )
        if self.data_array.ndim != 5:
            raise ValueError("data_array must be 5-dimensional (vec, feed, freq, za, az)")
        if self.data_array.shape[2] != self.freq_array.size:
            raise ValueError("data_array freq axis does not match freq_array")
        if self.data_array.shape[3] != self.axis2_array.size:
            raise ValueError("data_array za axis does not match axis2_array")
        if self.data_array.shape[4] != self.axis1_array.size:
            raise ValueError("data_array az axis does not match axis1_array")
        _check_uniform(self.axis1_array, "axis1_array (az)")
        _check_uniform(self.axis2_array, "axis2_array (za)")

    @property
    def Nfreqs(self) -> int:
        return self.freq_array.size

    @property
    def az_wraps(self) -> bool:
        """Whether the az grid covers the full circle (periodic indexing)."""
        daz = self.axis1_array[1] - self.axis1_array[0]
        span = self.axis1_array[-1] - self.axis1_array[0]
        return bool(abs(span + daz - 2 * np.pi) < 1e-8 or abs(span - 2 * np.pi) < 1e-8)

    def interp_freq(self, freqs) -> "GriddedBeam":
        """Linear interpolation onto new frequencies (host, setup time)."""
        freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
        if self.Nfreqs == 1:
            data = np.repeat(self.data_array, len(freqs), axis=2)
            data.setflags(write=False)
            return GriddedBeam(
                data, self.axis1_array, self.axis2_array, freqs,
                self.beam_type, feeds=self.feeds,
            )
        if freqs.min() < self.freq_array.min() - 1e-3 or freqs.max() > self.freq_array.max() + 1e-3:
            raise ValueError(
                f"Requested frequencies [{freqs.min()}, {freqs.max()}] outside "
                f"beam range [{self.freq_array.min()}, {self.freq_array.max()}]"
            )
        old = self.freq_array
        idx = np.clip(np.searchsorted(old, freqs, side="left"), 1, self.Nfreqs - 1)
        f0, f1 = old[idx - 1], old[idx]
        t = ((freqs - f0) / (f1 - f0))[None, None, :, None, None]
        out = self.data_array[:, :, idx - 1] * (1 - t) + self.data_array[:, :, idx] * t
        out.setflags(write=False)
        return GriddedBeam(
            out, self.axis1_array, self.axis2_array, freqs, self.beam_type,
            feeds=self.feeds,
        )

    def as_power_beam(self) -> "GriddedBeam":
        """E-field -> power: P_feed = sum_vec |E_vec,feed|^2 (the diagonal
        pols)."""
        if self.beam_type == "power":
            return self
        power = np.ascontiguousarray(
            np.sum(np.abs(self.data_array) ** 2, axis=0, keepdims=True).real
        )
        power.setflags(write=False)
        return GriddedBeam(
            power, self.axis1_array, self.axis2_array, self.freq_array,
            "power", feeds=self.feeds,
        )

    @classmethod
    def from_function(
        cls,
        beam,
        n_az: int = 360,
        n_za: int = 181,
        freqs=(150e6,),
        za_max: float = np.pi,
    ) -> "GriddedBeam":
        """Tabulate an analytic beam's ``efield`` onto a grid (float64)."""
        az = np.linspace(0.0, 2 * np.pi, n_az, endpoint=False)
        za = np.linspace(0.0, za_max, n_za)
        freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
        azg, zag = np.meshgrid(az, za)  # (nza, naz)
        data = np.empty((2, 2, len(freqs), n_za, n_az), dtype=np.complex128)
        az_t, za_t = torch.from_numpy(azg.ravel()), torch.from_numpy(zag.ravel())
        for fi, f in enumerate(freqs):
            e = beam.efield(az_t, za_t, float(f)).numpy()
            data[:, :, fi] = e.reshape(2, 2, n_za, n_az)
        data.setflags(write=False)
        return cls(data, az, za, freqs, "efield", feeds=["x", "y"])

    @classmethod
    def from_uvbeam(cls, uvb) -> "GriddedBeam":
        """Adapt a (duck-typed) pyuvdata UVBeam in az_za coordinates.

        Honors the UVBeam attributes the JAX package honors: 5D or 6D
        (one spectral window) ``data_array``, ``(Nfreqs,)`` or ``(1,
        Nfreqs)`` ``freq_array``, ``feed_array`` ordering (x/east first),
        ``x_orientation`` ("north" swaps the dipole labels) and an identity
        ``basis_vector_array``.
        """
        if getattr(uvb, "pixel_coordinate_system", "az_za") != "az_za":
            raise ValueError("Only az_za UVBeams can be adapted.")
        bva = getattr(uvb, "basis_vector_array", None)
        if bva is not None:
            bva = np.asarray(bva)
            if bva.ndim != 4 or bva.shape[:2] != (2, 2):
                raise ValueError(
                    "basis_vector_array must be (Naxes_vec=2, 2, Nza, Naz); "
                    f"got {bva.shape}"
                )
            want = np.zeros_like(bva)
            want[0, 0] = 1.0
            want[1, 1] = 1.0
            if not np.allclose(bva, want, atol=1e-6):
                raise ValueError(
                    "UVBeam basis_vector_array is not the standard az/za "
                    "unit basis; rotate the E-field components with "
                    "pyuvdata before adapting (a non-identity basis would "
                    "silently mix the vector components)."
                )
        data = np.asarray(uvb.data_array)
        if data.ndim == 6:
            if data.shape[1] != 1:
                raise ValueError(
                    "Multi-spectral-window UVBeams are not supported"
                )
            data = data[:, 0]
        if data.ndim != 5:
            raise ValueError(
                f"UVBeam data_array must be 5D or 6D, got {data.ndim}D"
            )
        feeds = [
            str(f).lower() for f in np.atleast_1d(getattr(uvb, "feed_array", []))
        ]
        xorient = str(getattr(uvb, "x_orientation", None) or "east").lower()
        if xorient not in ("east", "north"):
            raise ValueError(f"Unrecognized x_orientation: {xorient!r}")
        if xorient == "north":
            remap = {"x": "n", "y": "e", "n": "n", "e": "e"}
            feeds = [remap.get(f, f) for f in feeds]
        if feeds in (["n", "e"], ["y", "x"]):
            if data.shape[1] != len(feeds):
                raise ValueError(
                    "Cannot reorder a y-first UVBeam whose polarization "
                    f"axis ({data.shape[1]}) differs from Nfeeds "
                    f"({len(feeds)}); reorder feeds with pyuvdata first"
                )
            data = data[:, ::-1]
            feeds = feeds[::-1]
        elif feeds and feeds not in (["e", "n"], ["x", "y"], ["e"], ["x"], ["n"], ["y"]):
            raise ValueError(f"Unrecognized UVBeam feed ordering: {feeds}")
        label_map = {"e": "x", "n": "y", "x": "x", "y": "y"}
        feed_labels = (
            [label_map[f] for f in feeds]
            if feeds and len(feeds) == data.shape[1]
            else None
        )
        return cls(
            data,
            np.asarray(uvb.axis1_array, dtype=float).ravel(),
            np.asarray(uvb.axis2_array, dtype=float).ravel(),
            np.asarray(uvb.freq_array, dtype=float).ravel(),
            getattr(uvb, "beam_type", "efield"),
            feeds=feed_labels,
        )


def _check_uniform(arr: np.ndarray, name: str, tol: float = 1e-8):
    if arr.size < 2:
        return
    d = np.diff(arr)
    if np.any(np.abs(d - d[0]) > tol * max(abs(d[0]), 1e-12)):
        raise ValueError(f"{name} must be uniformly spaced for table interpolation")
