"""Multi-device work over a single-controller device Mesh: the sharded
bundle-adjustment solver (the front-end's data-parallel batch is
PPGExtractor.extract_batch(mesh=))."""

from .mesh import Mesh
from .sharded_ba import (
    dryrun_sharded_ba_step,
    make_vi_problem,
    pad_problem_for_mesh,
    solve_ba_sharded,
)

__all__ = [
    "Mesh",
    "solve_ba_sharded",
    "pad_problem_for_mesh",
    "make_vi_problem",
    "dryrun_sharded_ba_step",
]
