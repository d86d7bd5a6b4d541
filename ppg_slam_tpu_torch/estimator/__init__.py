from .ba_core import (
    DOF,
    BAOptions,
    BAProblem,
    KFStates,
    empty_problem,
    solve_ba,
)
from .pose_opt import (
    FrameVIState,
    PreintData,
    Prior15,
    marginalize_schur,
    pose_inertial_optimization,
    pose_optimization,
)
from . import robust

__all__ = [
    "DOF",
    "BAOptions",
    "BAProblem",
    "KFStates",
    "empty_problem",
    "solve_ba",
    "FrameVIState",
    "PreintData",
    "Prior15",
    "marginalize_schur",
    "pose_inertial_optimization",
    "pose_optimization",
    "robust",
]
