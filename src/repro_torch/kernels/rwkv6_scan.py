"""Wrapper for the RWKV6 WKV-scan CUDA kernel in `csrc/rwkv6_scan.cu`,
the counterpart of `repro.kernels.rwkv6_scan.rwkv6_scan` (a Pallas TPU
kernel).

`rwkv6_scan(r, k, v, logw, u, *, chunk)` keeps `repro`'s signature
without `interpret`: r, k, v, logw are (B, T, H, hd), f32 or bf16, u is
(H, hd); the output is f32 (B, T, H, hd), the recurrence run from a zero
state.  T must be a multiple of `chunk`, `repro`'s time block, which the
CUDA kernel does not otherwise use.

Dispatch is by device: a CPU tensor runs the plain version
(`ref.rwkv6_scan_ref`); a CUDA tensor launches the kernel on PyTorch's
current stream or raises.  The kernel reads the operands through their
strides (the last one must be 1).  The kernel takes any hd up to
`MAX_HEAD_DIM` = 256 (`repro`'s takes any hd; a larger one raises here).
No autograd.  Launches are counted in `launch_counts()`.
"""
from __future__ import annotations

import torch

from ._cuda_lib import DTYPE_CODE, LL, CudaLibrary, I, P, check_operands
from .ref import rwkv6_scan_ref

MAX_HEAD_DIM = 256
_LIB = CudaLibrary("rwkv6_scan", {
    # r, k, v, logw, u, out, B, T, H, hd, dtype, 3 strides each of
    # r, k, v, logw
    "rwkv6_scan": (P, P, P, P, P, P, I, I, I, I, I, *(LL,) * 12)})
_LAUNCHES = {"rwkv6_scan": 0}


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["rwkv6_scan"] = 0


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, *,
               chunk: int = 64) -> torch.Tensor:
    """out_t = r_t (S + diag(u) k_tᵀv_t), S ← diag(e^{logw_t}) S + k_tᵀv_t
    from S = 0; returns f32 (B, T, H, hd).  T % chunk == 0 is required
    (`repro`'s assertion)."""
    check_operands(("r", "k", "v", "logw"), (r, k, v, logw),
                   "(B, T, H, hd)")
    B, T, H, hd = r.shape
    if not isinstance(u, torch.Tensor) or tuple(u.shape) != (H, hd) \
            or u.device != r.device or u.dtype not in DTYPE_CODE:
        raise ValueError(f"u must be a float32 or bfloat16 (H, hd) = "
                         f"{(H, hd)} tensor on {r.device}")
    if u.requires_grad:
        raise ValueError("u requires grad; the kernel has no backward")
    if chunk < 1 or T % chunk:
        raise ValueError(f"T = {T} must be a multiple of chunk = {chunk}")
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, logw, u, chunk=chunk)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"the WKV-scan kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    u32 = u.to(torch.float32).contiguous()
    out = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    strides = [s for t in (r, k, v, logw) for s in t.stride()[:3]]
    _LIB.launch("rwkv6_scan", r.device, r.data_ptr(), k.data_ptr(),
                v.data_ptr(), logw.data_ptr(), u32.data_ptr(),
                out.data_ptr(), B, T, H, hd, DTYPE_CODE[r.dtype], *strides)
    _LAUNCHES["rwkv6_scan"] += 1
    return out
