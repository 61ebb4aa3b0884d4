"""Wrappers for the gossip CUDA kernels in `csrc/mixing_matvec.cu`.

Counterparts of the plain (uncompressed, full-stripe) paths of
`repro.kernels.mixing_matvec`:

  * `circulant_mix_matvec`   — W·Y or (I−W)·Y for circulant W,
  * `sparse_mix_matvec`      — the same for any W from padded (n, k)
                               neighbor/weight tables,
  * `circulant_neumann_step` — one fused DIHGP Neumann iteration
                               h⁺ = (D̃h − (I−W)h − β·hvp_h − p)/D̃.

Dispatch is by the operand's device and nothing else: a CPU tensor runs
the plain PyTorch version (`repro_torch.kernels.ref`, in f32 — the
kernels accumulate in f32 for bf16 inputs too); a CUDA tensor launches
the kernel on PyTorch's current stream or raises.  Outputs have the
input's dtype and are allocated here with `torch.empty`.

The kernels take any n ≥ 1 and any d (the ragged edge is masked), f32
or bf16.  The circulant offsets and weights are device tables of any
length, as the sparse kernel's are (`circulant_tables` builds them).
Like the gather indices they are not range-checked here: that would
synchronize every launch.  No autograd: like `repro`'s Pallas tiers they register no
backward, so an operand that requires grad is refused.

Each wrapper counts its kernel launches in a plain integer attribute
(`circulant_mix_matvec.launches`, ...), bumped only where it launches;
`launch_counts` / `reset_launch_counts` read and zero all three.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import circulant_mix_ref, neumann_step_ref, sparse_mix_padded_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "circulant_mix": (_P, _P, _I, _I, _I, _F, _I, _P, _P, _I, _P),
    "sparse_mix": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "circulant_neumann": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P, _P,
                          _F, _P),
}


def _kernel(name: str):
    lib = _build.load("mixing_matvec")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = list(_SIGNATURES[name])
        fn.restype = ctypes.c_int
        lib.mixing_error_string.argtypes = [ctypes.c_int]
        lib.mixing_error_string.restype = ctypes.c_char_p
    return fn, lib


def _launch(name: str, dev: torch.device, *args) -> None:
    fn, lib = _kernel(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, _P(stream))
    if rc != 0:
        msg = lib.mixing_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def _check_state(name: str, t, shape=None, like=None) -> None:
    """A kernel operand of shape (n, d): f32/bf16, contiguous, no grad."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.dim() != 2 or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f"{name} must be a non-empty (n, d) matrix, got "
                         f"shape {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} must be float32 or bfloat16, got "
                         f"{t.dtype}")
    if like is not None and (t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                         f"{like.dtype} on {like.device}")
    _check_common(name, t)
    if t.shape[0] > _INT_MAX or t.shape[1] > _INT_MAX:
        raise ValueError(f"{name} dimensions exceed int32: "
                         f"{tuple(t.shape)}")


def _check_table(name: str, t, shape, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device:
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)} "
                         f"on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    _check_common(name, t)


def _check_common(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.requires_grad:
        raise ValueError(f"{name} requires grad; the mixing kernels have "
                         f"no backward (the algorithm never "
                         f"differentiates through a gossip)")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on {t.device}; expected cpu or cuda")


def circulant_tables(n: int, offsets, weights, device):
    """The circulant kernels' (k,) int32 offset and (k,) f32 weight
    tables on `device`, offsets reduced into [0, n)."""
    offsets = [int(o) % n for o in offsets]
    weights = [float(c) for c in weights]
    if len(offsets) != len(weights):
        raise ValueError(f"{len(offsets)} offsets but {len(weights)} "
                         f"weights")
    return (torch.tensor(offsets, dtype=torch.int32, device=device),
            torch.tensor(weights, dtype=torch.float32, device=device))


def _check_circulant(offsets, weights, device) -> int:
    k = offsets.shape[0] if isinstance(offsets, torch.Tensor) \
        and offsets.dim() == 1 else -1
    _check_table("offsets", offsets, (k,), torch.int32, device)
    _check_table("weights", weights, (k,), torch.float32, device)
    return k


def circulant_mix_matvec(y: torch.Tensor, *, w_self: float,
                         offsets: torch.Tensor, weights: torch.Tensor,
                         laplacian: bool = False) -> torch.Tensor:
    """W·Y (or (I−W)·Y) for circulant W; y: (n, d) f32 or bf16.

    W[i, (i+o) mod n] = c_o for o, c_o in zip(offsets, weights),
    W[i, i] = w_self; offsets (k,) int32 in [0, n) and weights (k,) f32
    on y's device (`circulant_tables`).  f32 accumulation, output in y's
    dtype."""
    _check_state("y", y)
    n, d = y.shape
    k = _check_circulant(offsets, weights, y.device)
    if y.device.type == "cpu":
        return circulant_mix_ref(y.float(), float(w_self), offsets.tolist(),
                                 weights.tolist(), laplacian).to(y.dtype)
    out = torch.empty_like(y)
    _launch("circulant_mix", y.device, y.data_ptr(), out.data_ptr(), n, d,
            _DTYPE_CODE[y.dtype], float(w_self), k, offsets.data_ptr(),
            weights.data_ptr(), int(bool(laplacian)))
    circulant_mix_matvec.launches += 1
    return out


def sparse_mix_matvec(y: torch.Tensor, w_self: torch.Tensor,
                      neighbors: torch.Tensor, weights: torch.Tensor, *,
                      laplacian: bool = False) -> torch.Tensor:
    """W·Y (or (I−W)·Y) for any W from padded tables; y: (n, d).

    w_self: (n,) f32 diagonal; neighbors: (n, k) int32 with every entry
    in [0, n); weights: (n, k) f32 — padded slots hold the row's own
    index with weight 0 (`repro_torch.topology.structure
    .sparse_structure`, which builds them in range from W).  Indices are
    not range-checked here: that would synchronize every launch."""
    _check_state("y", y)
    n, d = y.shape
    k = neighbors.shape[1] if neighbors.dim() == 2 else -1
    _check_table("w_self", w_self, (n,), torch.float32, y.device)
    _check_table("neighbors", neighbors, (n, k), torch.int32, y.device)
    _check_table("weights", weights, (n, k), torch.float32, y.device)
    if y.device.type == "cpu":
        return sparse_mix_padded_ref(y.float(), w_self, neighbors, weights,
                                     laplacian).to(y.dtype)
    out = torch.empty_like(y)
    _launch("sparse_mix", y.device, y.data_ptr(), out.data_ptr(),
            w_self.data_ptr(), neighbors.data_ptr(), weights.data_ptr(), n,
            d, k, _DTYPE_CODE[y.dtype], int(bool(laplacian)))
    sparse_mix_matvec.launches += 1
    return out


def circulant_neumann_step(h: torch.Tensor, hvp_h: torch.Tensor,
                           p: torch.Tensor, d_scalar: torch.Tensor, *,
                           w_self: float, offsets: torch.Tensor,
                           weights: torch.Tensor,
                           beta: float) -> torch.Tensor:
    """One fused DIHGP Neumann iteration (Eq. 14) for circulant W:

        h⁺ = (D̃h − (I−W)h − β·hvp_h − p) / D̃

    h, hvp_h, p: (n, d), one dtype (f32; bf16 is accepted and
    accumulated in f32); d_scalar: (n, 1) f32 per-agent D̃; the
    circulant W as in `circulant_mix_matvec`; β a Python number (a
    runtime kernel argument)."""
    _check_state("h", h)
    _check_state("hvp_h", hvp_h, h.shape, like=h)
    _check_state("p", p, h.shape, like=h)
    n, d = h.shape
    _check_table("d_scalar", d_scalar, (n, 1), torch.float32, h.device)
    k = _check_circulant(offsets, weights, h.device)
    if h.device.type == "cpu":
        return neumann_step_ref(h.float(), hvp_h.float(), p.float(),
                                d_scalar, w_self=float(w_self),
                                offsets=offsets.tolist(),
                                weights=weights.tolist(),
                                beta=float(beta)).to(h.dtype)
    out = torch.empty_like(h)
    _launch("circulant_neumann", h.device, h.data_ptr(), hvp_h.data_ptr(),
            p.data_ptr(), d_scalar.data_ptr(), out.data_ptr(), n, d,
            _DTYPE_CODE[h.dtype], float(w_self), k, offsets.data_ptr(),
            weights.data_ptr(), float(beta))
    circulant_neumann_step.launches += 1
    return out


KERNELS = (circulant_mix_matvec, sparse_mix_matvec, circulant_neumann_step)
for _k in KERNELS:
    _k.launches = 0


def launch_counts() -> dict[str, int]:
    """{wrapper name: kernel launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
