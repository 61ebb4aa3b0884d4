"""repro_torch.kernels — hand-written CUDA kernels for Hopper (sm_90a).

`csrc/` holds the CUDA sources, `_build` compiles them with nvcc at
first use.  `mixing_matvec` wraps the gossip kernels (launching on CUDA
tensors, running the plain PyTorch versions of `ref` on CPU tensors) and
plans their row tiles against the card's shared memory;
the modules `flash_attention` and `rwkv6_scan` wrap the attention and
WKV-scan kernels the same way, and `ops` is the counterpart of
`repro.kernels.ops`: `attention`, `wkv` and `ring_laplacian` behind the
kernel switch (`kernel_mode`), exported here as `repro` exports its
own.  `launch_counts` gathers every kernel's launches.
"""
from . import flash_attention as _fa
from . import mixing_matvec as _mm
from . import rwkv6_scan as _wkv
from .mixing_matvec import (circulant_mix_matvec, circulant_mix_matvec_halo,
                            circulant_neumann_step, pick_halo_bn,
                            ring_laplacian_matvec, sparse_mix_matvec,
                            sparse_mix_matvec_halo)
from .ops import (attention, kernel_mode, kernels_enabled, ring_laplacian,
                  use_kernels, wkv)

_MODULES = (_mm, _fa, _wkv)


def launch_counts() -> dict[str, int]:
    """{kernel name: launches since the last reset}, every kernel."""
    return {name: n for m in _MODULES for name, n in m.launch_counts().items()}


def reset_launch_counts() -> None:
    for m in _MODULES:
        m.reset_launch_counts()


__all__ = ["attention", "circulant_mix_matvec", "circulant_mix_matvec_halo",
           "circulant_neumann_step", "kernel_mode", "kernels_enabled",
           "launch_counts", "pick_halo_bn", "reset_launch_counts",
           "ring_laplacian", "ring_laplacian_matvec", "sparse_mix_matvec",
           "sparse_mix_matvec_halo", "use_kernels", "wkv"]
