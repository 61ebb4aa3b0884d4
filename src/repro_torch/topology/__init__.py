"""repro_torch.topology — the decentralized-network subsystem (paper §3).

  * `graphs`    — adjacency generators + connectivity (numpy),
  * `weights`   — Metropolis / max-degree / uniform mixing matrices and
                  spectral diagnostics (numpy),
  * `structure` — shift-invariant and padded/CSR structure extraction
                  (numpy),
  * `ops`       — `Network`, the `MixingOp` executor (dense torch matmul
                  / circulant CUDA kernels / sparse-gather CUDA kernel)
                  and the free-function façade every algorithm calls.
"""
from .graphs import (circulant_graph, complete_graph, erdos_renyi_graph,
                     is_connected, ring_graph, star_graph)
from .ops import (BACKENDS, MIXING_DTYPES, MaskedMixingOp, MixingOp,
                  Network, _neumann_update,
                  as_matrix, fused_neumann_step, fused_neumann_step_c,
                  laplacian_apply, laplacian_apply_c, make_mixing_op,
                  make_network, mix_apply, mix_apply_c,
                  resolve_mixing_dtype)
from .structure import (CirculantStructure, SparseStructure,
                        circulant_structure, sparse_structure)
from .weights import (check_assumption_a, max_degree_weights,
                      metropolis_weights, mixing_rate, neumann_rho,
                      self_weight_bounds, spectral_gap, uniform_averaging)

__all__ = [
    "circulant_graph", "complete_graph", "erdos_renyi_graph",
    "is_connected", "ring_graph", "star_graph",
    "check_assumption_a", "max_degree_weights", "metropolis_weights",
    "mixing_rate", "neumann_rho", "self_weight_bounds", "spectral_gap",
    "uniform_averaging",
    "CirculantStructure", "SparseStructure", "circulant_structure",
    "sparse_structure",
    "BACKENDS", "MIXING_DTYPES", "MaskedMixingOp", "MixingOp", "Network", "as_matrix",
    "fused_neumann_step", "fused_neumann_step_c", "laplacian_apply",
    "laplacian_apply_c", "make_mixing_op", "make_network", "mix_apply",
    "mix_apply_c", "resolve_mixing_dtype",
]
