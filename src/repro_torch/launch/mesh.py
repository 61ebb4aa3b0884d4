"""Device-mesh factories on `torch.distributed`.

`make_production_mesh` lays the production layout — (data=16,
model=16), or (pod=2, data=16, model=16) across two pods — over the
ranks of the default process group, which the launcher (`torchrun` or
the caller's `init_process_group`) has created with that many ranks.
`make_host_mesh` is the small mesh over whatever ranks exist, creating a
one-rank group on this process (gloo on the CPU, NCCL on a card) when
none is initialised, as the tests and examples need.  Both are functions,
so importing this module touches no process group.

The roofline constants are the card's: an NVIDIA H100 SXM's HBM3 rate,
dense bf16 tensor-core peak and NVLink rate (data sheet, at its 700 W
limit: NVLink 4, 900 GB/s per GPU in both directions together, so 450
GB/s each way).
"""
from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist

H100_PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense
H100_HBM_BYTES_PER_S = 3.35e12    # bytes/s
H100_NVLINK_BYTES_PER_S = 450e9   # bytes/s, one direction


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ensure_group(device_type: str) -> None:
    """A default process group: the caller's; else the one `torchrun`
    describes in the environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT); else this process alone."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                     "MASTER_PORT")):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(data=16, model=16), or (pod=2, data=16, model=16), over the
    default process group's ranks (256 or 512 of them)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized() or dist.get_world_size() != math.prod(shape):
        raise RuntimeError(
            f"the production mesh {dict(zip(axes, shape))} needs a process "
            f"group of {math.prod(shape)} ranks (torchrun)")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, *, device_type: str | None = None):
    """(data=n // model, model) over the default group's n ranks (one
    rank, this process, where no group exists); gloo on the CPU."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    _ensure_group(device_type)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model = {model}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
