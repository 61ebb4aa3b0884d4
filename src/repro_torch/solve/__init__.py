"""repro_torch.solve — the solver front-end of the port.

    from repro_torch.solve import SolverSpec, ScheduleSpec, solve
    res = solve(prob, net, SolverSpec(method="dagm", K=5, M=5, U=3,
                                      dihgp="matrix_free"))
    # the sharded tier, all agents on one card
    from repro_torch.distributed import LocalRing
    res = solve(prob, None, sharded_spec(curvature=c, K=5),
                mesh=LocalRing(prob.n))
"""
from .api import SolveResult, solve
from .spec import (METHODS, TIERS, CommSpec, MixingSpec, RoundSchedules,
                   ScheduleSpec, ShardedSpec, SolverSpec, dagm_spec,
                   mixing_kwargs, sharded_spec, validate_spec)

__all__ = [
    "CommSpec", "METHODS", "MixingSpec", "RoundSchedules", "ScheduleSpec",
    "ShardedSpec", "SolveResult", "SolverSpec", "TIERS", "dagm_spec",
    "mixing_kwargs", "sharded_spec", "solve", "validate_spec",
]
