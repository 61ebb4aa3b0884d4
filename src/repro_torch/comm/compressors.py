"""Gossip compressors — a torch copy of `repro.comm.compressors`.

Every cross-agent exchange moves a stacked per-agent payload: row i of
an (n, ...) tensor is what agent i broadcasts to its neighbors.  A
`Compressor` simulates the compress→decompress roundtrip of that
broadcast *in values* (the decoded tensor is what neighbors mix with)
and reports the *exact* number of bytes one agent's message occupies on
the wire (`payload_bytes`) — the quantity `CommLedger` accumulates.

Contract (as in `repro`)
------------------------
* `roundtrip(x, seed, row=0)` is row-wise: agent i's decoded message
  depends only on row i.  `row` is the agent index of x's first row,
  so that a rank of the sharded tier's process ring, which holds one
  agent's row, draws what that agent's row of a stacked call draws.
* `seed` is a host integer, consumed only when `stochastic` is True.
  The stochastic quantizers draw their uniforms from the position-keyed
  `hash_uniform(seed, row, col)` of `repro_torch.kernels.ref` — the
  same numbers the comm-fused CUDA kernels draw, on every device — and
  `rand_k` draws its indices, row after row, from a CPU
  `torch.Generator` seeded with `seed`.  `repro` draws both from `jax.random`; only the statistics
  carry over.
* `payload_bytes(shape)` / `payload_floats(shape)` take the *per-agent*
  payload shape (x.shape[1:]) and return Python ints.

Specs are strings: ``identity`` | ``bf16`` | ``int8`` | ``int4`` |
``top_k:<frac>`` | ``rand_k:<frac>``, each optionally suffixed ``+ef``
for CHOCO-style error feedback — parsed by `parse_comm_spec`.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.ref import _PAYLOAD_BLOCK, hash_uniform, quantize

F32_BYTES = 4
BF16_BYTES = 2
# quantizer metadata: per-row scale + zero-point, each sent as bf16
QUANT_META_BYTES = 2 * BF16_BYTES
# rand_k regenerates its indices from a shared seed; only a 4-byte
# round tag crosses the wire beside the values
RANDK_META_BYTES = 4
# top_k ships explicit indices: int32 per surviving coordinate
TOPK_INDEX_BYTES = 4


def _payload_size(shape) -> int:
    return int(math.prod(shape)) if shape else 1


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def row_quant_params(flat: torch.Tensor, bits: int):
    """Per-row (zero-point, scale) of the `bits`-bit stochastic
    quantizer, each rounded through bf16 because that is what the wire
    carries; bitwise equal to `repro.comm.row_quant_params`.

    zp = min → bf16 (round to nearest even) → f32; scale = span/levels
    (1 where the row is constant), inflated by one bf16 ulp (×(1+2⁻⁷))
    so the top code never clips by more than rounding noise, → bf16 →
    f32.  The division is tensor by tensor: torch turns a division by a
    Python number into a multiplication by its reciprocal on the card,
    which is not bitwise `span / levels`.  flat: (n, F); returns two
    (n, 1) f32 tensors.

    A span/levels below the smallest normal f32 counts as a constant
    row (scale 1): `repro`'s XLA code flushes subnormals to zero, so a
    subnormal span gets scale 1 there too, and a subnormal quotient
    would flush to a zero scale, which makes (x − zp)/scale = 0/0 at
    the row's minimum and the decoded payload NaN.  torch keeps
    subnormals on both devices, where that zero scale came from a
    row of tiny DIHGP iterates (the n = 4096 ring, int4)."""
    levels = float(2 ** bits - 1)
    flat = flat.float()
    zp = flat.amin(dim=1, keepdim=True).to(torch.bfloat16).float()
    span = flat.amax(dim=1, keepdim=True) - zp
    raw = span / torch.full_like(span, levels)
    scale = torch.where(raw >= torch.finfo(torch.float32).tiny, raw,
                        torch.ones_like(span))
    scale = (scale * (1.0 + 2.0 ** -7)).to(torch.bfloat16).float()
    return zp, scale


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base: the identity wire (full-precision f32 vectors)."""
    name: str = "identity"
    stochastic: bool = False
    # a fusable compressor's roundtrip is per-row (zp, scale) metadata
    # plus elementwise stochastic rounding, which the comm-fused CUDA
    # kernels compute inside the mix
    fusable: bool = False

    def roundtrip(self, x: torch.Tensor, seed: int | None = None,
                  row: int = 0) -> torch.Tensor:
        return x

    def payload_floats(self, shape) -> int:
        return _payload_size(shape)

    def payload_bytes(self, shape) -> int:
        return F32_BYTES * _payload_size(shape)


@dataclasses.dataclass(frozen=True)
class Bf16Compressor(Compressor):
    """Deterministic bfloat16 rounding of the wire copy."""
    name: str = "bf16"

    def roundtrip(self, x, seed=None, row=0):
        return x.to(torch.bfloat16).to(x.dtype)

    def payload_bytes(self, shape) -> int:
        return BF16_BYTES * _payload_size(shape)


@dataclasses.dataclass(frozen=True)
class StochasticQuantCompressor(Compressor):
    """`bits`-bit stochastic quantization, scale + zero-point per row.

    q = ⌊(x − zp)/scale + u⌋ clipped to [0, 2^bits − 1], decoded as
    zp + scale·q, with (zp, scale) from `row_quant_params` and u from
    `hash_uniform(seed, row, col)`: E[decode] = x wherever x ≥ zp.  The
    row minimum may lie below its bf16-rounded zp; there the code clips
    at 0 and the decode is biased by zp − min (at most half a bf16 ulp
    of |min|), as in `repro`."""
    name: str = "int8"
    stochastic: bool = True
    fusable: bool = True
    bits: int = 8

    def roundtrip(self, x, seed=None, row=0):
        flat = _rows(x)
        n, size = flat.shape
        dev = flat.device
        # the wire metadata depends on each row's extremes only, and the
        # code is elementwise: blocks of columns keep the f32 and int64
        # temporaries of a parameter-sized row near _PAYLOAD_BLOCK
        # elements, bit for bit the whole-row roundtrip
        zp, scale = row_quant_params(torch.cat(
            [flat.amin(1, keepdim=True), flat.amax(1, keepdim=True)], 1)
            .float(), self.bits)
        rows = torch.arange(row, row + n, device=dev)[:, None]
        out = torch.empty_like(flat)
        step = max(1, _PAYLOAD_BLOCK // max(n, 1))
        for c0 in range(0, size, step):
            c1 = min(size, c0 + step)
            u = hash_uniform(int(seed), rows,
                             torch.arange(c0, c1, device=dev)[None, :])
            out[:, c0:c1] = quantize(flat[:, c0:c1].float(), zp, scale, u,
                                     float(2 ** self.bits - 1)).to(x.dtype)
        return out.reshape(x.shape)

    def payload_bytes(self, shape) -> int:
        codes = math.ceil(_payload_size(shape) * self.bits / 8)
        return codes + QUANT_META_BYTES


def _k_of(frac: float, size: int) -> int:
    return max(1, min(size, int(round(frac * size))))


@dataclasses.dataclass(frozen=True)
class TopKCompressor(Compressor):
    """Keep the k = max(1, round(frac·F)) largest-magnitude coordinates
    per row.  Biased but contractive — pair with error feedback.  Wire:
    k f32 values + k int32 indices."""
    name: str = "top_k"
    frac: float = 0.1

    def roundtrip(self, x, seed=None, row=0):
        flat = _rows(x)
        k = _k_of(self.frac, flat.shape[1])
        idx = torch.topk(flat.abs(), k, dim=1).indices
        out = torch.zeros_like(flat).scatter_(1, idx, flat.gather(1, idx))
        return out.reshape(x.shape)

    def payload_bytes(self, shape) -> int:
        k = _k_of(self.frac, _payload_size(shape))
        return k * (F32_BYTES + TOPK_INDEX_BYTES)


@dataclasses.dataclass(frozen=True)
class RandKCompressor(Compressor):
    """Keep k uniformly random coordinates per row, drawn without
    replacement from a CPU `torch.Generator` seeded with the send's seed
    (the same indices on every device).  `scale=True` rescales by F/k
    so E[C(x)] = x; under error feedback the scaling is off, since the
    F/k inflation is an expansion for k < F/2 and breaks the EF
    contraction (`parse_comm_spec` picks the variant)."""
    name: str = "rand_k"
    stochastic: bool = True
    frac: float = 0.25
    scale: bool = True

    def roundtrip(self, x, seed=None, row=0):
        flat = _rows(x)
        n, size = flat.shape
        k = _k_of(self.frac, size)
        gain = (size / k) if self.scale else 1.0
        gen = torch.Generator().manual_seed(int(seed))
        # rows before `row` draw first, so row r's indices are the r-th
        # draw of the stream however the rows are split
        idx = torch.stack([torch.randperm(size, generator=gen)[:k]
                           for _ in range(row + n)][row:]).to(flat.device)
        out = torch.zeros_like(flat).scatter_(1, idx,
                                              flat.gather(1, idx) * gain)
        return out.reshape(x.shape)

    def payload_bytes(self, shape) -> int:
        k = _k_of(self.frac, _payload_size(shape))
        return k * F32_BYTES + RANDK_META_BYTES


def make_compressor(base: str) -> Compressor:
    """Compressor from the base spec (no `+ef` suffix)."""
    if base in ("identity", "f32"):
        return Compressor()
    if base == "bf16":
        return Bf16Compressor()
    if base in ("int8", "int4"):
        return StochasticQuantCompressor(name=base, bits=int(base[3:]))
    for prefix, cls in (("top_k:", TopKCompressor),
                        ("rand_k:", RandKCompressor)):
        if base.startswith(prefix):
            frac = float(base[len(prefix):])
            if not 0.0 < frac <= 1.0:
                raise ValueError(f"{prefix[:-1]} fraction must be in "
                                 f"(0, 1], got {frac}")
            return cls(frac=frac)
    raise ValueError(
        f"unknown compressor spec {base!r}; expected identity | bf16 | "
        f"int8 | int4 | top_k:<frac> | rand_k:<frac> (optionally +ef)")


@dataclasses.dataclass(frozen=True)
class CommPolicy:
    """A parsed comm spec: the compressor plus whether error feedback
    wraps it."""
    spec: str
    compressor: Compressor
    ef: bool

    @property
    def is_identity(self) -> bool:
        return self.compressor.name == "identity"

    @property
    def stochastic(self) -> bool:
        return self.compressor.stochastic

    @property
    def fusable(self) -> bool:
        """True for the int8/int4 quantizers (± EF), whose roundtrip the
        comm-fused kernels compute inside the mix."""
        return self.compressor.fusable


def parse_comm_spec(spec: str) -> CommPolicy:
    """"<compressor>[+ef]" -> CommPolicy (see module docstring)."""
    base, sep, opt = spec.partition("+")
    if sep and opt != "ef":
        raise ValueError(f"unknown comm option {opt!r} in {spec!r}; "
                         f"the only modifier is '+ef'")
    ef = opt == "ef"
    comp = make_compressor(base)
    if ef and comp.name == "identity":
        raise ValueError("'identity+ef' is meaningless: error feedback "
                         "compensates a lossy compressor")
    if ef and isinstance(comp, RandKCompressor):
        comp = dataclasses.replace(comp, scale=False)
    return CommPolicy(spec=spec, compressor=comp, ef=ef)
