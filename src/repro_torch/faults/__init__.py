"""repro_torch.faults: fault injection and dynamic-network degradation.

See `repro_torch.faults.faults` for the degradation semantics (realized
W_k stays symmetric doubly stochastic) and `repro_torch.topology.ops
.MixingOp.masked` for the execution path on the padded sparse-gather
kernels.
"""
from .faults import FaultSpec, FaultTrace, lower_faults, realized_W

__all__ = [
    "FaultSpec",
    "FaultTrace",
    "lower_faults",
    "realized_W",
]
