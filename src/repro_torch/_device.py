"""Device resolution and the float32 scope shared by every entry point of
the port."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another one.

    Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and no card is present — the port never carries on on the
    CPU unless ``device="cpu"`` was passed.  ``"meta"`` is taken too: a
    dry run (`repro_torch.launch.dryrun`) traces the entry points on it
    and allocates nothing.  Sets no global state: the entry points keep
    float32 in full precision inside `strict_f32`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:        # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; expected cuda, cpu "
                         f"or meta")
    return dev


@contextlib.contextmanager
def strict_f32():
    """Run a block with TF32 off for matmuls and convolutions, so that
    float32 stays float32, and give the caller's two flags
    (`torch.backends.cuda.matmul.allow_tf32`,
    `torch.backends.cudnn.allow_tf32`) back on exit, exception or not.
    Also a decorator: `solve`, `MixingOp`'s gossips and the
    `kernels.ops` entry points run inside it.  The attention kernel's
    TF32 `mma` is an explicit instruction these flags do not touch."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
