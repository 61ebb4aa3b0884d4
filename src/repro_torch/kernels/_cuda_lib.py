"""The one launch path of the port's kernels: a library built from one
`csrc/<name>.cu`, its C entry points bound with ctypes and launched on
PyTorch's current stream (`CudaLibrary`, used by every wrapper), and the
checks on the attention and WKV-scan wrappers' (B, S, H, hd) operands.
Nothing loads or builds at import: the first `launch` builds the library
(`_build.load`)."""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

P, I, F, LL, U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong, ctypes.c_uint32
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
CARD_SMS = 132          # the H100's SMs, which the planners' rules fill


@functools.lru_cache(maxsize=None)
def card_sms(dev: torch.device) -> int:
    """The SMs of the card `dev` (read once per device)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


class CudaLibrary:
    """The C entry points of `csrc/<name>.cu`.  Each returns a CUDA error
    code (0 on success) and takes the stream as its last argument;
    `signatures` maps each entry point to its other argument types."""

    def __init__(self, name: str, signatures: dict[str, tuple]):
        self.name = name
        self.signatures = signatures

    def _fn(self, entry: str):
        lib = _build.load(self.name)
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.argtypes = [*self.signatures[entry], P]
            fn.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
        return fn, lib

    def launch(self, entry: str, dev: torch.device, *args) -> None:
        """Call `entry(*args, stream)` on `dev`'s current stream; raise
        RuntimeError when it reports an error (the launch was refused)."""
        fn, lib = self._fn(entry)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*args, P(stream))
        if rc != 0:
            msg = lib.kernel_error_string(rc).decode()
            raise RuntimeError(f"{entry} kernel launch failed: {msg} ({rc})")


def check_operands(names, tensors, shape_of: str) -> None:
    """Same-shaped (B, S|T, H, hd) operands: f32 or bf16, one dtype and
    device, last stride 1, no grad."""
    first = tensors[0]
    for name, t in zip(names, tensors):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dim() != 4 or min(t.shape) < 1:
            raise ValueError(f"{name} must be a non-empty {shape_of} "
                             f"tensor, got shape {tuple(t.shape)}")
        if t.shape != first.shape or t.dtype != first.dtype \
                or t.device != first.device:
            raise ValueError(
                f"{name} is {t.dtype} {tuple(t.shape)} on {t.device}; "
                f"expected {first.dtype} {tuple(first.shape)} on "
                f"{first.device}, as {names[0]}")
        if t.dtype not in DTYPE_CODE:
            raise ValueError(f"{name} must be float32 or bfloat16, got "
                             f"{t.dtype}")
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError(f"{name} must have a contiguous last "
                             f"dimension (stride 1), got strides "
                             f"{t.stride()}")
        if t.requires_grad:
            raise ValueError(f"{name} requires grad; the kernel has no "
                             f"backward")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} is on {t.device}; expected cpu or "
                             f"cuda")
