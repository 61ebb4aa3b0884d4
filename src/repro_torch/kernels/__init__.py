"""repro_torch.kernels — hand-written CUDA kernels for Hopper (sm_90a).

`csrc/` holds the CUDA sources, `_build` compiles them with nvcc at
first use, `mixing_matvec` wraps them (launching on CUDA tensors, running
the plain PyTorch versions of `ref` on CPU tensors).
"""
from .mixing_matvec import (circulant_mix_matvec, circulant_neumann_step,
                            launch_counts, reset_launch_counts,
                            ring_laplacian_matvec, sparse_mix_matvec)

__all__ = ["circulant_mix_matvec", "circulant_neumann_step",
           "launch_counts", "reset_launch_counts", "ring_laplacian_matvec",
           "sparse_mix_matvec"]
