"""Utils facade: the port's HEALPix pixel math and geometry helpers."""

from ..core.utils import get_plane_to_xy_rotation_matrix, get_pos_reds, speed_of_light
from .healpix import healpix_radec, nside2npix, pix2ang_ring

__all__ = [
    "get_plane_to_xy_rotation_matrix",
    "get_pos_reds",
    "healpix_radec",
    "nside2npix",
    "pix2ang_ring",
    "speed_of_light",
]
