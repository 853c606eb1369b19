from .erfa_lite import TelescopeLocation, times_to_jd
from .rotation import COORD_METHODS, SourceRotation, enu_to_az_za

__all__ = [
    "COORD_METHODS",
    "SourceRotation",
    "TelescopeLocation",
    "enu_to_az_za",
    "times_to_jd",
]
