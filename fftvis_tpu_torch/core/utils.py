"""Host-side geometry utilities (NumPy).

NumPy copies of the helpers of ``fftvis_tpu/core/utils.py`` that the port's
slice needs: redundant-baseline grouping, the plane-to-XY rotation of a
tilted array and the speed of light. Tests assert that each copy gives
exactly the arrays of the original.
"""

from __future__ import annotations

import numpy as np

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
