"""Host-side geometry utilities (NumPy).

NumPy copies of the helpers of ``fftvis_tpu/core/utils.py`` that the port's
slice needs: redundant-baseline grouping, the plane-to-XY rotation of a
tilted array, the source-chunk memory model, the antenna-to-beam mapping
check and the speed of light. Tests assert that each copy gives exactly the
arrays (and error messages) of the original.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

speed_of_light = 299792458.0  # m/s


def get_pos_reds(antpos: dict, decimals: int = 3, include_autos: bool = True):
    """Group baselines into redundant sets from antenna positions.

    Parameters
    ----------
    antpos
        Mapping ``{ant_key: position (3,)}``.
    decimals
        Rounding precision (in position units) used to decide redundancy.
    include_autos
        Whether auto-correlations form a (single) redundant group.

    Returns
    -------
    list of list of tuple
        Each inner list is one redundant group of ``(ai, aj)`` antenna pairs.
        The representative (first) baseline of each group is oriented so that
        its y-component is non-negative, matching the reference convention so
        that downstream defaults pick identical baselines.
    """
    keys = list(antpos.keys())
    n = len(keys)
    row = {k: r for r, k in enumerate(keys)}
    pos_arr = np.array([np.asarray(antpos[k], dtype=float) for k in keys])

    # Pair list in the reference's iteration order (outer ai, inner aj,
    # key-comparison filter), then ONE vectorized round over all deltas:
    # the per-pair np.round calls were ~0.5 s/call at 331 antennas (55k
    # small-array allocations), a majority of the steady-state host wall.
    pair_idx = [
        (i, j)
        for i in range(n)
        for j in range(n)
        if (include_autos and i == j) or keys[i] < keys[j]
    ]
    if not pair_idx:
        return []
    ij = np.asarray(pair_idx, dtype=np.int64)
    duv = np.round(
        pos_arr[ij[:, 1], :2] - pos_arr[ij[:, 0], :2], decimals
    ).tolist()

    # (u, v) -> group key; groups keyed by their first-seen baseline.
    uv_lookup: dict[tuple, tuple] = {}
    groups: dict[tuple, list[tuple]] = {}

    for (i, j), (u, v) in zip(pair_idx, duv):
        ai, aj = keys[i], keys[j]
        uv = (u, v)
        nuv = (-u, -v)
        if uv not in uv_lookup and nuv not in uv_lookup:
            uv_lookup[uv] = (ai, aj)
            groups[(ai, aj)] = [(ai, aj)]
        elif nuv in uv_lookup:
            groups[uv_lookup[nuv]].append((aj, ai))
        else:
            groups[uv_lookup[uv]].append((ai, aj))

    out = []
    for (a1, a2), group in groups.items():
        bly = pos_arr[row[a2], 1] - pos_arr[row[a1], 1]
        if bly < 0:
            out.append([(bj, bi) for bi, bj in group])
        else:
            out.append(group)
    return out


def get_plane_to_xy_rotation_matrix(antvecs: np.ndarray) -> np.ndarray:
    """Rotation matrix bringing a (possibly tilted) planar array into the XY plane.

    Least-squares fit of a plane z = ax + by + c to the antenna positions,
    followed by a Rodrigues rotation aligning the plane normal with +z.
    (ref core/utils.py:74-119)
    """
    antvecs = np.asarray(antvecs, dtype=float)
    x, y, z = antvecs.T
    design = np.column_stack([x, y, np.ones_like(x)])
    (sx, sy, _), *_ = np.linalg.lstsq(design, z, rcond=None)

    if np.isclose(sx, 0.0) and np.isclose(sy, 0.0):
        return np.eye(3)

    normal = np.array([sx, sy, -1.0])
    normal /= np.linalg.norm(normal)

    axis = np.array([sy, -sx, 0.0])
    axis /= np.linalg.norm(axis)
    theta = np.arccos(-normal[2])

    K = np.array(
        [
            [0.0, -axis[2], axis[1]],
            [axis[2], 0.0, -axis[0]],
            [-axis[1], axis[0], 0.0],
        ]
    )
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def get_required_chunks(
    freemem: int,
    nax: int,
    nfeed: int,
    nant: int,
    nsrc: int,
    nbeam: int,
    nbeampix: int,
    precision: int,
    source_buffer: float = 1.0,
    nprocesses: int = 1,
) -> int:
    """Number of source chunks needed to fit the working set in ``freemem`` bytes.

    Byte-level model mirroring the reference (ref core/utils.py:213-285),
    used against the device's free memory.
    """
    rsize = 4 * precision
    csize = 2 * rsize

    total = freemem
    ch = 0
    while total >= freemem and ch < 100:
        ch += 1
        nchunk = int(nsrc // ch * source_buffer)
        sizes = {
            "antpos": nant * 3 * rsize,
            "flux": nsrc * rsize,
            "beam": nbeampix * nfeed * nax * csize,
            "crd_eq": 3 * nsrc * rsize,
            "crd_top": 3 * nsrc * rsize * nprocesses,
            "crd_chunk": 3 * nchunk * rsize * nprocesses,
            "flux_chunk": nchunk * rsize * nprocesses,
            "beam_interp": nbeam * nfeed * nax * nchunk * csize * nprocesses,
            "vis": ch * nfeed * nant * nfeed * nant * csize,
        }
        total = sum(sizes.values())
        logger.debug("nchunks=%d sizes=%s total=%d", ch, sizes, total)

    logger.info(
        "Free mem %.2f GB requires %d source chunks (estimate %.2f GB)",
        freemem / 1024**3,
        ch,
        total / 1024**3,
    )
    return ch


def get_desired_chunks(
    freemem: int,
    min_chunks: int,
    beam_list,
    nax: int,
    nfeed: int,
    nant: int,
    nsrc: int,
    precision: int,
    source_buffer: float = 1.0,
) -> tuple[int, int]:
    """Choose the number of source chunks and sources per chunk.

    (ref core/utils.py:287-355)
    """
    nbeampix = 0
    for beam in beam_list:
        data = getattr(beam, "data_array", None)
        if data is None and hasattr(beam, "beam"):
            data = getattr(beam.beam, "data_array", None)
        if data is not None:
            nbeampix += data.shape[-2] * data.shape[-1]

    nchunks = min(
        max(
            min_chunks,
            get_required_chunks(
                freemem,
                nax,
                nfeed,
                nant,
                nsrc,
                len(beam_list),
                nbeampix,
                precision,
                source_buffer,
            ),
        ),
        nsrc,
    )
    return nchunks, int(np.ceil(nsrc / nchunks))


def validate_beam_idx(
    beam_idx: np.ndarray | None,
    beam_coefs: np.ndarray | None,
    nbeam: int,
    nant: int,
) -> np.ndarray | None:
    """Validate / infer the antenna-to-beam mapping.

    Two mutually exclusive modes (ref core/utils.py:358-430):

    - per-antenna beams (``beam_coefs is None``): ``beam_idx`` maps antennas to
      entries of the beam list; inferred when unambiguous.
    - eigenbeams (``beam_coefs`` given): the mapping is defined by the
      coefficients and ``beam_idx`` must not be supplied.

    Error messages match the reference because its tests assert on them.
    """
    if beam_coefs is not None:
        if beam_idx is not None:
            raise ValueError(
                "beam_idx should not be provided when beam_coefs is given. "
                "The mapping from antennas to beams is defined by beam_coefs."
            )
        return None

    if beam_idx is None:
        if nbeam == nant:
            beam_idx = np.arange(nant)
        elif nbeam != 1:
            raise ValueError(
                "If number of beams provided is not 1 or nant, beam_idx must be provided."
            )

    if beam_idx is not None:
        beam_idx = np.asarray(beam_idx)
        if beam_idx.shape != (nant,):
            raise ValueError("beam_idx must be length nant")
        if not all(0 <= i < nbeam for i in beam_idx):
            raise ValueError(
                "beam_idx contains indices greater than the number of beams"
            )

    return beam_idx
