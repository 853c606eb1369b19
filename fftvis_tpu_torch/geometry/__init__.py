"""Array geometry: layout generators and baseline utilities.

Generators stand in for hera_sim.antpos (used by the reference's CLI and
tutorials; ref cli.py:80-81) since hera_sim is not a dependency here.
"""

from __future__ import annotations

import numpy as np

from ..core.antenna_gridding import check_antpos_griddability, find_lattice_basis
from ..core.utils import (
    get_plane_to_xy_rotation_matrix,
    get_pos_reds,
    speed_of_light,
)

__all__ = [
    "hex_array",
    "square_array",
    "line_array",
    "get_pos_reds",
    "get_plane_to_xy_rotation_matrix",
    "check_antpos_griddability",
    "find_lattice_basis",
    "speed_of_light",
]


def hex_array(hex_num: int, sep: float = 14.6, split_core: bool = False,
              outriggers: int = 0) -> dict:
    """Hexagonal close-packed array (HERA-style).

    Parameters
    ----------
    hex_num
        Number of antennas along a hexagon edge (hex_array(11) ~ 331 ants).
    sep
        Nearest-neighbor separation in meters.
    outriggers
        Adds rings of sparse outrigger antennas at ``(hex_num - 1) * k``
        lattice multiples, k = 1..outriggers, mimicking hera_sim's expanded
        configurations in scale.
    """
    if hex_num < 2:
        raise ValueError("hex_num must be >= 2")
    ants = {}
    i = 0
    for row in range(hex_num - 1, -hex_num, -1):
        n_in_row = 2 * hex_num - 1 - abs(row)
        for col in range(n_in_row):
            x = sep * (col - (n_in_row - 1) / 2)
            y = sep * row * np.sqrt(3) / 2
            ants[i] = np.array([x, y, 0.0])
            i += 1

    if outriggers:
        # Sparse outrigger grid on the same lattice (keeps griddability).
        spacing = (hex_num - 1) * sep
        e1 = np.array([spacing, 0.0])
        e2 = np.array([spacing / 2, spacing * np.sqrt(3) / 2])
        for k in range(-outriggers, outriggers + 1):
            for m in range(-outriggers, outriggers + 1):
                if k == 0 and m == 0:
                    continue
                p = k * e1 + m * e2
                ants[i] = np.array([p[0], p[1], 0.0])
                i += 1
    return ants


def square_array(n_side: int, sep: float = 14.6) -> dict:
    """n_side x n_side square grid."""
    ants = {}
    i = 0
    for r in range(n_side):
        for c in range(n_side):
            ants[i] = np.array([c * sep, r * sep, 0.0])
            i += 1
    return ants


def line_array(n: int, sep: float = 14.6) -> dict:
    """East-west line of n antennas."""
    return {i: np.array([i * sep, 0.0, 0.0]) for i in range(n)}
