"""Data association: the host matcher (a copy of the reference's), the
device gated-match service, relocalization PnP and loop closing's Sim3
RANSAC."""

from .device_match import DeviceMatcher, GatedRows
from .matcher import TH_HIGH, TH_LOW, Matcher, desc_dist_matrix
from .pnp import PnPSolver
from .sim3_solver import Sim3Solver, horn_sim3

__all__ = [
    "DeviceMatcher",
    "GatedRows",
    "Matcher",
    "TH_HIGH",
    "TH_LOW",
    "desc_dist_matrix",
    "PnPSolver",
    "Sim3Solver",
    "horn_sim3",
]
