"""Beamfits reading without pyuvdata.

A NumPy copy of the beamfits reader of ``fftvis_tpu/beams/io.py``
(:func:`read_beamfits` and its FITS helpers): a self-contained FITS reader
(2880-byte blocks of 80-char header cards + big-endian data) that
identifies axes by their ``CTYPE`` names, so any axis ordering a writer
chose parses. It returns a :class:`~fftvis_tpu_torch.beams.gridded.GriddedBeam`.
Host-side setup work only.
"""

from __future__ import annotations

import numpy as np

from .gridded import GriddedBeam

__all__ = ["read_beamfits"]


class _Namespace:
    def __init__(self, **kw):
        self.__dict__.update(kw)


_FITS_BLOCK = 2880
_BITPIX_DTYPE = {
    8: ">u1",
    16: ">i2",
    32: ">i4",
    64: ">i8",
    -32: ">f4",
    -64: ">f8",
}


def _parse_card(card: str):
    """Parse one 80-char header card -> (keyword, value) or None."""
    key = card[:8].strip()
    if not key or key in ("COMMENT", "HISTORY"):
        return None
    if card[8:10] != "= ":
        return (key, None) if key == "END" else None
    body = card[10:]
    if body.lstrip().startswith("'"):
        # String value: quotes with '' escaping.
        s = body.lstrip()
        out, i = [], 1
        while i < len(s):
            if s[i] == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(s[i])
            i += 1
        return key, "".join(out).rstrip()
    if "/" in body:
        body = body.split("/", 1)[0]
    v = body.strip()
    if v in ("T", "F"):
        return key, v == "T"
    if not v:
        return key, None
    try:
        return key, int(v)
    except ValueError:
        pass
    try:
        return key, float(v.replace("D", "E").replace("d", "e"))
    except ValueError:
        return key, v


def _read_hdus(path: str):
    """Read all image HDUs of a FITS file -> list of (header dict, ndarray)."""
    with open(path, "rb") as fh:
        buf = fh.read()
    hdus = []
    pos = 0
    while pos < len(buf):
        header = {}
        end = False
        hstart = pos
        while not end:
            if pos + _FITS_BLOCK > len(buf):
                if hdus and pos == hstart and not buf[pos:].strip(b"\x00 "):
                    return hdus  # trailing padding
                raise ValueError(f"Truncated FITS header in {path!r}")
            block = buf[pos : pos + _FITS_BLOCK].decode("ascii", errors="replace")
            pos += _FITS_BLOCK
            for ci in range(0, _FITS_BLOCK, 80):
                card = block[ci : ci + 80]
                if card[:3] == "END" and card[3:8].strip() == "":
                    end = True
                    break
                kv = _parse_card(card)
                if kv:
                    header[kv[0]] = kv[1]
        naxis = int(header.get("NAXIS", 0))
        shape_fits = [int(header[f"NAXIS{i}"]) for i in range(1, naxis + 1)]
        nelem = int(np.prod(shape_fits)) if shape_fits else 0
        bitpix = int(header["BITPIX"])
        dtype = np.dtype(_BITPIX_DTYPE[bitpix])
        nbytes = nelem * dtype.itemsize
        data = None
        if nelem:
            raw = buf[pos : pos + nbytes]
            if len(raw) < nbytes:
                raise ValueError(f"Truncated FITS data in {path!r}")
            data = np.frombuffer(raw, dtype=dtype).reshape(shape_fits[::-1])
            bscale = header.get("BSCALE", 1.0)
            bzero = header.get("BZERO", 0.0)
            if bscale != 1.0 or bzero != 0.0:
                data = data * bscale + bzero
            else:
                data = data.astype(dtype.newbyteorder("="))
            pos += -(-nbytes // _FITS_BLOCK) * _FITS_BLOCK
        hdus.append((header, data))
        if pos >= len(buf) or not buf[pos:].strip(b"\x00 "):
            break
    return hdus


# CTYPE spellings accepted for each logical axis (pyuvdata's names first).
_AXIS_NAMES = {
    "az": ("AZIMUTH",),
    "za": ("ZENANGLE", "ZENITH"),
    "freq": ("FREQ",),
    "feed": ("FEEDIND", "STOKES", "POLIND"),
    "spw": ("IF", "SPWIND", "SPW"),
    "vec": ("VECIND",),
    "complex": ("COMPLEX",),
}


def _axis_values(header: dict, ax: int, n: int) -> np.ndarray:
    crval = float(header.get(f"CRVAL{ax}", 0.0))
    cdelt = float(header.get(f"CDELT{ax}", 1.0))
    crpix = float(header.get(f"CRPIX{ax}", 1.0))
    return crval + cdelt * (np.arange(n) + 1.0 - crpix)


def read_beamfits(path: str) -> GriddedBeam:
    """Read a (pyuvdata-style) beamfits file into a :class:`GriddedBeam`.

    Requirements: an az_za coordinate system on a regular grid, and, when a
    BASISVEC extension is present, the standard az/za unit basis.
    """
    hdus = _read_hdus(path)
    header, data = hdus[0]
    if data is None:
        raise ValueError(f"{path!r}: primary HDU has no data")
    coordsys = str(header.get("COORDSYS", "az_za")).strip().lower()
    if coordsys != "az_za":
        raise ValueError(
            f"Only az_za beamfits files are supported (got {coordsys!r})"
        )
    beam_type = str(
        header.get("BTYPE", header.get("BEAMTYPE", "efield"))
    ).strip().lower()
    if beam_type not in ("efield", "power"):
        raise ValueError(f"Unrecognized beamfits beam type {beam_type!r}")

    naxis = int(header["NAXIS"])
    roles = {}
    for ax in range(1, naxis + 1):
        ctype = str(header.get(f"CTYPE{ax}", "")).strip().upper()
        for role, names in _AXIS_NAMES.items():
            if ctype in names:
                roles[role] = ax
                break
        else:
            raise ValueError(f"{path!r}: unrecognized CTYPE{ax} = {ctype!r}")
    for req in ("az", "za", "freq"):
        if req not in roles:
            raise ValueError(f"{path!r}: missing {req} axis (CTYPEn)")

    # numpy axis for FITS axis ax is (naxis - ax); lay out as
    # (complex, vec, spw, feed, freq, za, az), synthesizing missing
    # singleton axes.
    order_roles = ["complex", "vec", "spw", "feed", "freq", "za", "az"]
    perm, missing = [], []
    for i, role in enumerate(order_roles):
        if role in roles:
            perm.append(naxis - roles[role])
        else:
            missing.append(i)
    arr = np.transpose(data, perm)
    for i in missing:
        arr = np.expand_dims(arr, i)

    ncplx = arr.shape[0]
    if beam_type == "efield":
        if ncplx != 2:
            raise ValueError(
                f"{path!r}: efield beamfits needs a length-2 COMPLEX axis"
            )
        arr = arr[0] + 1j * arr[1]
    else:
        if ncplx != 1:
            raise ValueError(f"{path!r}: power beamfits has a COMPLEX axis")
        arr = arr[0]
    if arr.shape[1] != 1:
        raise ValueError(f"{path!r}: multiple spectral windows not supported")
    arr = arr[:, 0]  # (vec, feed, freq, za, az)

    def _vals(role):
        ax = roles[role]
        n = data.shape[naxis - ax]
        v = _axis_values(header, ax, n)
        unit = str(header.get(f"CUNIT{ax}", "")).strip().lower()
        if role in ("az", "za") and unit in ("", "deg", "degree", "degrees"):
            v = np.deg2rad(v)
        return v

    az, za, freqs = _vals("az"), _vals("za"), _vals("freq")

    feeds = None
    fl = header.get("FEEDLIST")
    if fl is not None:
        feeds = [f.strip().strip("'\"").lower() for f in str(fl).strip("[] ").split(",") if f.strip()]
    if beam_type == "efield" and feeds is not None and len(feeds) != arr.shape[1]:
        raise ValueError(
            f"{path!r}: FEEDLIST {feeds} does not match the feed axis "
            f"length {arr.shape[1]}"
        )

    basis = None
    for hdr_e, data_e in hdus[1:]:
        if str(hdr_e.get("EXTNAME", "")).strip().upper() == "BASISVEC":
            basis = data_e
            if basis is not None:
                basis = np.asarray(basis)

    ns = _Namespace(
        data_array=arr,
        axis1_array=az,
        axis2_array=za,
        freq_array=freqs,
        beam_type=beam_type,
        feed_array=np.asarray(feeds) if feeds else np.asarray([]),
        x_orientation=header.get("XORIENT", "east"),
        pixel_coordinate_system="az_za",
    )
    if basis is not None:
        ns.basis_vector_array = basis
    return GriddedBeam.from_uvbeam(ns)
