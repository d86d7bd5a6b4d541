"""Data association: the host matcher (a copy of the reference's), the
device gated-match service and relocalization PnP. The Sim3 solver waits
for loop closing (ROADMAP.md)."""

from .device_match import DeviceMatcher, GatedRows
from .matcher import TH_HIGH, TH_LOW, Matcher, desc_dist_matrix
from .pnp import PnPSolver

__all__ = [
    "DeviceMatcher",
    "GatedRows",
    "Matcher",
    "TH_HIGH",
    "TH_LOW",
    "desc_dist_matrix",
    "PnPSolver",
]
