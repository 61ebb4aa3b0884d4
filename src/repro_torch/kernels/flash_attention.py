"""Wrapper for the flash-attention CUDA kernel in
`csrc/flash_attention.cu`, the counterpart of `repro.kernels
.flash_attention.flash_attention` (a Pallas TPU kernel).

`flash_attention(q, k, v, *, causal, window, bq, bk)` keeps `repro`'s
signature without `interpret`: q, k, v are (B, S, H, hd) with the same
head count (grouped-query heads are broadcast beforehand, e.g. with
`repeat_interleave` on the head axis), f32 or bf16, and the output has
q's dtype.  The causal mask and the window mask (q − k) < window apply
independently — the kernel's semantics, which differ from
`attention_ref`'s for causal=False with a window (`ref.py`).

Dispatch is by device: a CPU tensor runs the plain version
(`ref.flash_attention_ref`); a CUDA tensor launches the kernel on
PyTorch's current stream or raises.  The kernel reads the operands
through their strides (the last one must be 1), so (B, H, S, hd)
transposed views need no copy.  `bq` and `bk` are `repro`'s TPU block
sizes: S must be a multiple of both, as there, but the CUDA kernel uses
its own tiles (64 q rows; 64 keys, or 32 in f32 and above hd = 128).
Both dtypes run on the tensor cores: bf16 `mma` with p split in three
bf16 parts, and f32 in 3×TF32 (`csrc/flash_attention.cu`).  The kernel
takes any hd up to `MAX_HEAD_DIM` = 256, padded in shared memory;
`repro`'s takes any hd, and a larger one raises here.  No autograd: an
operand that requires grad is refused.  Launches are counted in
`launch_counts()`.
"""
from __future__ import annotations

import math

import torch

from ._cuda_lib import (DTYPE_CODE, LL, CudaLibrary, F, I, P,
                        check_operands)
from .ref import flash_attention_ref

MAX_HEAD_DIM = 256
_LIB = CudaLibrary("flash_attention", {
    # q, k, v, o, B, S, H, hd, dtype, 3 strides each of q, k, v,
    # scale, causal, window
    "flash_attention": (P, P, P, P, I, I, I, I, I, LL, LL, LL, LL, LL, LL,
                        LL, LL, LL, F, I, I)})
_LAUNCHES = {"flash_attention": 0}


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["flash_attention"] = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """Softmax(q·kᵀ/√hd, masked)·v on (B, S, H, hd); returns (B, S, H, hd)
    in q's dtype.  S % bq == S % bk == 0 is required (`repro`'s
    assertion); window ≥ 0, 0 for none."""
    check_operands(("q", "k", "v"), (q, k, v), "(B, S, H, hd)")
    B, S, H, hd = q.shape
    if S % bq or S % bk:
        raise ValueError(f"S = {S} must be a multiple of bq = {bq} and "
                         f"bk = {bk}")
    window = int(window)
    if window < 0:
        raise ValueError(f"window must be >= 0 (0: none), got {window}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"the flash-attention kernel takes head dims up "
                         f"to {MAX_HEAD_DIM}, got {hd}")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    _LIB.launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), B, S, H, hd,
                DTYPE_CODE[q.dtype], *strides, 1.0 / math.sqrt(hd),
                int(bool(causal)), window)
    _LAUNCHES["flash_attention"] += 1
    return out
