"""repro_torch.launch — the LM workload's launchers (counterpart of
`repro.launch`): device meshes (`mesh`), the analytic cost model
(`costs`), the training launcher (`train`), the dry runs on the meta
device (`dryrun`) and the paper's decentralized bilevel LM round with
its dry run (`dagm_dryrun`).  `train`, `dryrun` and `dagm_dryrun` are
entry points (`python -m repro_torch.launch.<name>`), imported by name."""
from .mesh import (H100_HBM_BYTES_PER_S, H100_NVLINK_BYTES_PER_S,
                   H100_PEAK_FLOPS_BF16, make_host_mesh,
                   make_production_mesh)

__all__ = ["H100_HBM_BYTES_PER_S", "H100_NVLINK_BYTES_PER_S",
           "H100_PEAK_FLOPS_BF16", "make_host_mesh", "make_production_mesh"]
