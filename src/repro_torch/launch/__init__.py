"""repro_torch.launch — device meshes for the LM workload (counterpart of
`repro.launch`; its trainer, cost model and dry runs are not ported
yet)."""
from .mesh import (H100_HBM_BYTES_PER_S, H100_PEAK_FLOPS_BF16,
                   make_host_mesh, make_production_mesh)

__all__ = ["H100_HBM_BYTES_PER_S", "H100_PEAK_FLOPS_BF16", "make_host_mesh",
           "make_production_mesh"]
