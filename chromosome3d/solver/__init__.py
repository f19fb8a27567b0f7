from chromosome3d.solver.init import mds_init, random_init, spiral_init, smooth_bounds
from chromosome3d.solver.anneal import (
    AnnealResult,
    build_schedule,
    solve_single,
    solve_ensemble,
)

__all__ = [
    "mds_init",
    "random_init",
    "spiral_init",
    "smooth_bounds",
    "AnnealResult",
    "build_schedule",
    "solve_single",
    "solve_ensemble",
]
