"""repro_torch.solve — the solver front-end of the port.

    from repro_torch.solve import SolverSpec, ScheduleSpec, solve
    res = solve(prob, net, SolverSpec(method="dagm", K=5, M=5, U=3,
                                      dihgp="matrix_free"))
"""
from .api import SolveResult, solve
from .spec import (METHODS, TIERS, CommSpec, MixingSpec, RoundSchedules,
                   ScheduleSpec, SolverSpec, dagm_spec,
                   mixing_kwargs, validate_spec)

__all__ = [
    "CommSpec", "METHODS", "MixingSpec", "RoundSchedules", "ScheduleSpec",
    "SolveResult", "SolverSpec", "TIERS", "dagm_spec",
    "mixing_kwargs", "solve", "validate_spec",
]
