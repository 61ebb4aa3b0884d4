"""Gossip wire policies — the identity wire of `repro.comm.compressors`.

A `Compressor` simulates the compress→decompress roundtrip of one
agent's broadcast in values and reports the exact bytes that broadcast
occupies on the wire.  This slice of the port carries the identity wire
only (full-precision f32 vectors): `parse_comm_spec("identity")`.  The
lossy compressors of `repro.comm` (bf16, int8/int4 stochastic
quantization, top-k, rand-k, error feedback) raise NotImplementedError
until ROADMAP queue 1 item 5 ports them.
"""
from __future__ import annotations

import dataclasses
import math

F32_BYTES = 4

_QUEUED = ("bf16", "int8", "int4", "top_k:", "rand_k:")


def _payload_size(shape) -> int:
    return int(math.prod(shape)) if shape else 1


@dataclasses.dataclass(frozen=True)
class Compressor:
    """The identity wire (full-precision f32 vectors)."""
    name: str = "identity"

    def payload_floats(self, shape) -> int:
        return _payload_size(shape)

    def payload_bytes(self, shape) -> int:
        return F32_BYTES * _payload_size(shape)


def make_compressor(base: str) -> Compressor:
    """Compressor from the base spec (no `+ef` suffix)."""
    if base in ("identity", "f32"):
        return Compressor()
    if base.startswith(_QUEUED):
        raise NotImplementedError(
            f"compressor {base!r} is not ported yet (ROADMAP queue 1 item "
            f"5, compressed gossip); the port runs comm='identity'")
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


def parse_comm_spec(spec: str) -> CommPolicy:
    """"<compressor>[+ef]" -> CommPolicy (identity only in this slice)."""
    base, sep, opt = spec.partition("+")
    if sep and opt != "ef":
        raise ValueError(f"unknown comm option {opt!r} in {spec!r}; "
                         f"the only modifier is '+ef'")
    ef = opt == "ef"
    comp = make_compressor(base)
    if ef and comp.name == "identity":
        raise ValueError("'identity+ef' is meaningless: error feedback "
                         "compensates a lossy compressor")
    return CommPolicy(spec=spec, compressor=comp, ef=ef)
