"""Wrapper for the RWKV6 WKV-scan CUDA kernel in `csrc/rwkv6_scan.cu`,
the counterpart of `repro.kernels.rwkv6_scan.rwkv6_scan` (a Pallas TPU
kernel).

`rwkv6_scan(r, k, v, logw, u, *, chunk)` keeps `repro`'s signature
without `interpret`: r, k, v, logw are (B, T, H, hd), f32 or bf16, u is
(H, hd); the output is f32 (B, T, H, hd), the recurrence run from a zero
state.  With `return_state=True` the same launch also writes the final
state S_T, f32 (B, H, hd, hd), which a model's prefill hands to decode
(`repro`'s model takes it from its `lax.scan`); it returns (out, S_T),
and the plain version is `ref.rwkv6_ref(...)`.  T must be a multiple of `chunk`, `repro`'s time block; the CUDA
kernel scans its own chunks of `WKV_CHUNK` steps, which need not divide
T.

Dispatch is by device: a CPU tensor runs the plain version
(`ref.rwkv6_scan_ref`); a CUDA tensor launches the kernel on PyTorch's
current stream or raises.  The kernel reads the operands through their
strides (the last one must be 1) and takes any hd ≥ 1, as `repro`'s
does: each block holds `plan_wkv_cols` columns of the (hd × hd) state
over all hd rows, in shared memory where that fits
(`wkv_smem_bytes`) and else in a device-memory scratch allocated here.
No autograd.  Launches are counted in `launch_counts()`: those with the
state output as `rwkv6_scan_state`, the others as `rwkv6_scan`.
"""
from __future__ import annotations

import torch

from ._cuda_lib import (CARD_SMS, DTYPE_CODE, LL, CudaLibrary, I, P,
                        card_sms, check_operands)
from .ref import rwkv6_ref, rwkv6_scan_ref

_LIB = CudaLibrary("rwkv6_scan", {
    # r, k, v, logw, u, out, state scratch, final state, B, T, H, hd,
    # dtype, cols, 3 strides each of r, k, v, logw
    "rwkv6_scan": (P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                   *(LL,) * 12)})
_LAUNCHES = {"rwkv6_scan": 0, "rwkv6_scan_state": 0}

# The kernel's geometry (csrc/rwkv6_scan.cu): chunks of WKV_CHUNK steps,
# row tiles of WKV_ROWS rows, a ring of WKV_STAGES units, and the state
# tile's column widths, widest first.
WKV_CHUNK, WKV_ROWS, WKV_STAGES = 16, 64, 3
WKV_COLS = (64, 32, 16)
WKV_SMEM_BYTES = 232_448        # dynamic shared memory a block may use
_DERIVED = WKV_CHUNK * (WKV_ROWS + 8) + WKV_ROWS * (WKV_CHUNK + 4) \
    + WKV_ROWS * 108 + WKV_ROWS
_SCORES = WKV_CHUNK * (WKV_CHUNK + 4)


def wkv_state_rows(hd: int) -> int:
    """Rows of one column of a block's state tile: hd rounded up to the
    row tiles, plus 4."""
    return -(-hd // WKV_ROWS) * WKV_ROWS + 4


def wkv_smem_bytes(hd: int, cols: int, itemsize: int = 4,
                   state_shared: bool = True) -> int:
    """Shared memory of a launch: the ring of r, k, logw row tiles and v's
    columns (`itemsize`-byte values), the derived arrays and scores (f32)
    and, where `state_shared`, the (state rows, cols) f32 state tile."""
    stage = (3 * WKV_CHUNK * WKV_ROWS + WKV_CHUNK * cols) * itemsize
    return WKV_STAGES * stage + 4 * (_DERIVED + _SCORES) + (
        4 * cols * wkv_state_rows(hd) if state_shared else 0)


def plan_wkv_cols(B: int, H: int, hd: int, sms: int = CARD_SMS) -> int:
    """The state tile's columns per block: among `WKV_COLS` no wider than
    the narrowest that holds hd (64 above 32), the widest whose
    B·H·ceil(hd / cols) blocks give each of the card's `sms` SMs one (64
    at rwkv6-7b's B·H = 256), else the narrowest, 16.  Narrower tiles buy
    blocks with work every block repeats (the running sums and the
    scores over all hd rows)."""
    cap = next((c for c in reversed(WKV_COLS) if c >= hd), WKV_COLS[0])
    for c in WKV_COLS:
        if c <= cap and B * H * -(-hd // c) >= sms:
            return c
    return WKV_COLS[-1]


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
               return_state: bool = False):
    """out_t = r_t (S + diag(u) k_tᵀv_t), S ← diag(e^{logw_t}) S + k_tᵀv_t
    from S = 0; returns f32 (B, T, H, hd), or (out, S_T) with S_T f32
    (B, H, hd, hd) where `return_state`.  T % chunk == 0 is required
    (`repro`'s assertion).  The state tile's width is `plan_wkv_cols`',
    and it lives in shared memory where `wkv_smem_bytes` fits
    `WKV_SMEM_BYTES`, else in a device scratch (f32: hd above 512 at 64
    columns, above 2,368 at 16)."""
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
        if return_state:
            return rwkv6_ref(r, k, v, logw, u)
        return rwkv6_scan_ref(r, k, v, logw, u, chunk=chunk)
    cols = plan_wkv_cols(B, H, hd, card_sms(r.device))
    shared = wkv_smem_bytes(hd, cols, r.element_size()) <= WKV_SMEM_BYTES
    u32 = u.to(torch.float32).contiguous()
    out = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    scratch = None if shared else torch.empty(
        B * H * -(-hd // cols) * cols * wkv_state_rows(hd),
        dtype=torch.float32, device=r.device)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32,
                        device=r.device) if return_state else None
    strides = [s for t in (r, k, v, logw) for s in t.stride()[:3]]
    _LIB.launch("rwkv6_scan", r.device, r.data_ptr(), k.data_ptr(),
                v.data_ptr(), logw.data_ptr(), u32.data_ptr(),
                out.data_ptr(), None if scratch is None
                else scratch.data_ptr(), None if state is None
                else state.data_ptr(), B, T, H, hd, DTYPE_CODE[r.dtype],
                cols, *strides)
    if state is None:
        _LAUNCHES["rwkv6_scan"] += 1
        return out
    _LAUNCHES["rwkv6_scan_state"] += 1
    return out, state
