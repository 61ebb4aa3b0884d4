"""repro_torch.kernels — hand-written CUDA kernels for Hopper (sm_90a).

`csrc/` holds the CUDA sources, `_build` compiles them with nvcc at
first use, `mixing_matvec` wraps them (launching on CUDA tensors, running
the plain PyTorch versions of `ref` on CPU tensors) and plans their row
tiles against the card's shared memory.
"""
from .mixing_matvec import (circulant_mix_matvec, circulant_mix_matvec_halo,
                            circulant_neumann_step, launch_counts,
                            pick_halo_bn, reset_launch_counts,
                            ring_laplacian_matvec, sparse_mix_matvec,
                            sparse_mix_matvec_halo)

__all__ = ["circulant_mix_matvec", "circulant_mix_matvec_halo",
           "circulant_neumann_step", "launch_counts", "pick_halo_bn",
           "reset_launch_counts", "ring_laplacian_matvec",
           "sparse_mix_matvec", "sparse_mix_matvec_halo"]
