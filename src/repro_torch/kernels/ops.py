"""Public entry points for the port's kernels outside the gossip path —
the counterpart of `repro.kernels.ops` — and their on/off switch.

  * `ring_laplacian(y, w_self, w_edge)` — (I − W)·Y for a ring W;
  * `attention(q, k, v, *, causal, window)` — softmax attention;
  * `wkv(r, k, v, logw, u, *, chunk, return_state)` — the RWKV6 WKV
    mix from a zero state, and with `return_state` its final state too
    (a model's prefill).

Each keeps `repro`'s dispatch rules: with the switch on, the same shape
conditions send an input to the kernel (`ring_laplacian_matvec` when y
is f32 with n % 8 == 0, or bf16 with n % 16 == 0, and d % 128 == 0;
`flash_attention` when S % 128 == 0; `rwkv6_scan` when T % chunk == 0);
every other input, and every input with the switch off, goes to the
oracle (`ref.ring_laplacian_ref`, `ref.attention_ref`,
`ref.rwkv6_ref(...)[0]`, or the pair `ref.rwkv6_ref(...)`).  The kernel route of `attention` has the
kernel's masks (the window holds without causal too) and the oracle's
does not, exactly as in `repro`.

The switch is on by default: the port runs on the card and its kernels
are its path (`repro` defaults to off because its CPU path is the
oracle).  `kernel_mode(enabled)` sets it for a `with` block and restores
the previous state on exit, exception or not; `use_kernels(enabled)` is
the imperative form for whole-process scripts; `kernels_enabled()` reads
it.  It also governs `MixingOp`'s "auto" backend, read at each gossip as
`repro` reads `pallas_enabled()` (`repro_torch.topology.ops`).  A CUDA
kernel has no interpret mode, so `repro`'s `interpret` flag and
`REPRO_PALLAS_INTERPRET` have no counterpart.

With the switch on, a CPU tensor runs the kernel's plain version (the
wrappers dispatch by device) and a CUDA tensor launches the kernel or
raises; with it off, CUDA tensors run the oracles on the card, only
because the caller asked for that.  No route falls back when a build or
a launch fails.

These entry points take tensors and no parameters (the RWKV `u` is an
input), so `repro_torch.interop` has nothing to convert for them.  Each
runs inside `repro_torch.strict_f32`: TF32 is off for the oracles'
matmuls, and the caller's flags are back on return.
"""
from __future__ import annotations

import contextlib

import torch

from .._device import strict_f32
from . import ref
from .flash_attention import flash_attention
from .mixing_matvec import ring_laplacian_matvec
from .rwkv6_scan import rwkv6_scan

_ENABLED = True
# sublane minimum of `repro`'s TPU stripes, kept as its dispatch rule
_MIN_ROWS = {torch.float32: 8, torch.bfloat16: 16}


def use_kernels(enabled: bool) -> None:
    """Imperative switch for whole-process scripts (tests use
    `kernel_mode`)."""
    global _ENABLED
    _ENABLED = bool(enabled)


def kernels_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def kernel_mode(enabled: bool):
    """`with kernel_mode(False): ...` runs the block with the switch set
    and restores the previous state on exit, exception or not."""
    global _ENABLED
    saved = _ENABLED
    _ENABLED = bool(enabled)
    try:
        yield
    finally:
        _ENABLED = saved


@strict_f32()
def ring_laplacian(y: torch.Tensor, w_self: float, w_edge: float
                   ) -> torch.Tensor:
    """(I − W)·Y for ring W; y (n, d)."""
    sub = _MIN_ROWS.get(y.dtype)
    if _ENABLED and sub is not None and y.dim() == 2 \
            and y.shape[0] % sub == 0 and y.shape[1] % 128 == 0:
        return ring_laplacian_matvec(y, w_self=w_self, w_edge=w_edge)
    return ref.ring_laplacian_ref(y, w_self, w_edge)


@strict_f32()
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Softmax attention on (B, S, H, hd), the same head count."""
    if _ENABLED and q.shape[1] % 128 == 0:
        return flash_attention(q, k, v, causal=causal, window=window)
    return ref.attention_ref(q, k, v, causal=causal, window=window)


@strict_f32()
def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logw: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
        return_state: bool = False):
    """The RWKV6 WKV mix from a zero state, f32 (B, T, H, hd); with
    `return_state`, (out, S_T) with the final state f32 (B, H, hd, hd)."""
    if _ENABLED and r.shape[1] % chunk == 0:
        return rwkv6_scan(r, k, v, logw, u, chunk=chunk,
                          return_state=return_state)
    out, state = ref.rwkv6_ref(r, k, v, logw, u)
    return (out, state) if return_state else out
