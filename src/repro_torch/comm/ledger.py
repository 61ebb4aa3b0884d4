"""CommLedger — byte-accurate communication accounting.

One `Channel` per gossiped variable (the DAGM run has three: the inner
y exchanges, the DIHGP h exchanges, the outer x exchange; DGBO adds a
d2×d2 Hessian channel, DGTBO a d1×d2 JHIP channel, …).  A channel knows
its per-agent payload shape and compressor spec, hence the *exact* wire
bytes of one send (`Compressor.payload_bytes`) and the f32 bytes the
same send would have cost uncompressed; the number of sends comes from
the `ChannelState.sends` counters after a run (`charge_states`), so
loop trip counts are measured, never hand-maintained.

Conventions: counts are per-agent single-copy traffic — one "send" is
one agent broadcasting one payload to its neighborhood, the same unit
as the paper's Appendix-S1 "floats communicated per round" columns.
Multiply by the directed edge count (`network_multiplier`) for total
wire traffic on a concrete topology.

`MixingOp` owns a ledger and registers a channel per `comm_channel`
call, so the accounting sits exactly where the gossip executes; static
ledgers (`add_channel` with explicit sends) describe protocols that
never touch a MixingOp (FedNest's star, config-level previews).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

from .compressors import (CommPolicy, F32_BYTES, make_compressor,
                          parse_comm_spec)


@dataclasses.dataclass
class Channel:
    """Accounting record for one gossip channel.

    `sends` is the channel's total; when the channel was charged with a
    *job axis* (the `repro.serve` engine runs many independent DAGM
    instances through one vmapped bucket, each slot ticking its own
    counter), `sends_per_job` keeps the per-job breakdown and `sends`
    is its sum — so aggregate views stay scalar while
    `CommLedger.per_job_bytes` can attribute exact wire traffic to
    each job."""
    name: str
    payload_shape: tuple[int, ...]
    spec: str                   # compressor spec string
    floats_per_send: int        # uncompressed f32 words per send
    bytes_per_send: int         # exact wire bytes per send
    sends: int = 0              # filled post-run (or statically)
    sends_per_job: "object | None" = None   # np.ndarray (jobs,) or None

    @property
    def bytes(self) -> int:
        return self.sends * self.bytes_per_send

    @property
    def floats(self) -> int:
        return self.sends * self.floats_per_send

    @property
    def uncompressed_bytes(self) -> int:
        return self.floats * F32_BYTES


class CommLedger:
    """Ordered collection of channels + aggregate views."""

    def __init__(self, name: str = "comm"):
        self.name = name
        self.channels: dict[str, Channel] = {}

    # -- building ---------------------------------------------------------

    def register(self, name: str, payload_shape, policy: CommPolicy
                 ) -> Channel:
        """Open (or re-validate) a channel; called by MixingOp at
        channel-init time, before any traced work."""
        shape = tuple(int(s) for s in payload_shape)
        ch = self.channels.get(name)
        if ch is not None:
            if ch.payload_shape != shape or ch.spec != policy.spec:
                raise ValueError(
                    f"channel {name!r} re-registered with different "
                    f"shape/spec: {ch.payload_shape}/{ch.spec} vs "
                    f"{shape}/{policy.spec}")
            return ch
        comp = policy.compressor
        ch = Channel(name=name, payload_shape=shape, spec=policy.spec,
                     floats_per_send=comp.payload_floats(shape),
                     bytes_per_send=comp.payload_bytes(shape))
        self.channels[name] = ch
        return ch

    def add_channel(self, name: str, payload_shape, *,
                    spec: str = "identity", sends: int = 0,
                    floats_per_send: int | None = None,
                    bytes_per_send: int | None = None) -> Channel:
        """Static channel (protocols that never run through MixingOp:
        FedNest's star routing, config-level previews).  Explicit
        floats/bytes override the compressor arithmetic, e.g. to charge
        the 2× up+down star transfers as one channel."""
        shape = tuple(int(s) for s in payload_shape)
        comp = make_compressor(spec.partition("+")[0])
        ch = Channel(
            name=name, payload_shape=shape, spec=spec,
            floats_per_send=(comp.payload_floats(shape)
                             if floats_per_send is None
                             else int(floats_per_send)),
            bytes_per_send=(comp.payload_bytes(shape)
                            if bytes_per_send is None
                            else int(bytes_per_send)),
            sends=int(sends))
        self.channels[name] = ch
        return ch

    # -- charging ---------------------------------------------------------

    def charge(self, name: str, sends) -> None:
        """Set a channel's send count.  `sends` may be a scalar (the
        single-run case) or an array with one entry per job (a serve
        bucket's per-slot counters): arrays are kept as the per-job
        breakdown and summed into the scalar total."""
        import numpy as np
        arr = np.asarray(sends)
        ch = self.channels[name]
        if arr.ndim == 0:
            ch.sends, ch.sends_per_job = int(arr), None
        else:
            ch.sends_per_job = arr.astype(np.int64)
            ch.sends = int(arr.sum())

    def charge_states(self, states: Iterable) -> None:
        """Read the traced send counters back from ChannelStates after a
        run (the counters counted through every scan/fori_loop body).
        Counters that picked up a leading job axis under vmap charge
        per-job."""
        for st in states:
            self.charge(st.name, st.sends)

    # -- aggregates -------------------------------------------------------

    @property
    def total_bytes(self) -> int:
        return sum(ch.bytes for ch in self.channels.values())

    @property
    def total_floats(self) -> int:
        return sum(ch.floats for ch in self.channels.values())

    @property
    def total_uncompressed_bytes(self) -> int:
        return self.total_floats * F32_BYTES

    def total_sends(self) -> int:
        return sum(ch.sends for ch in self.channels.values())

    # -- per-job views (channels charged with a job axis) -----------------

    def per_job_sends(self) -> "dict[str, object]":
        """{channel: (jobs,) send counts} for channels charged with a
        job axis (empty dict when none were)."""
        return {name: ch.sends_per_job
                for name, ch in self.channels.items()
                if ch.sends_per_job is not None}

    def per_job_bytes(self):
        """(jobs,) exact wire bytes attributed to each job, summed over
        the channels charged with a job axis; None when no channel was.
        By construction `per_job_bytes().sum() == total_bytes` for a
        ledger whose channels were all charged per-job — the additivity
        the serve tests pin down."""
        per = [ch.sends_per_job * ch.bytes_per_send
               for ch in self.channels.values()
               if ch.sends_per_job is not None]
        return sum(per) if per else None

    def per_job_floats(self):
        """(jobs,) uncompressed f32 words per job; None when no channel
        was charged with a job axis."""
        per = [ch.sends_per_job * ch.floats_per_send
               for ch in self.channels.values()
               if ch.sends_per_job is not None]
        return sum(per) if per else None

    def vectors_per_round(self, rounds: int) -> dict[str, float]:
        return {name: ch.sends / rounds
                for name, ch in self.channels.items()}

    def floats_per_round(self, rounds: int) -> float:
        return self.total_floats / rounds

    def bytes_per_round(self, rounds: int) -> float:
        return self.total_bytes / rounds

    def reduction_vs_f32(self) -> float:
        """Uncompressed-f32 bytes / actual wire bytes (≥ 1)."""
        return self.total_uncompressed_bytes / max(self.total_bytes, 1)

    def network_multiplier(self, num_edges: int) -> int:
        """Directed sends per broadcast exchange: 2·|E| (each agent to
        each neighbor)."""
        return 2 * int(num_edges)

    def summary(self, rounds: int | None = None) -> dict:
        out = {
            "name": self.name,
            "channels": {
                name: {"payload_shape": list(ch.payload_shape),
                       "spec": ch.spec, "sends": ch.sends,
                       "bytes_per_send": ch.bytes_per_send,
                       "floats_per_send": ch.floats_per_send,
                       "bytes": ch.bytes}
                for name, ch in self.channels.items()},
            "total_bytes": self.total_bytes,
            "total_floats": self.total_floats,
            "reduction_vs_f32": round(self.reduction_vs_f32(), 4),
        }
        if rounds:
            out["rounds"] = rounds
            out["bytes_per_round"] = self.bytes_per_round(rounds)
            out["floats_per_round"] = self.floats_per_round(rounds)
        return out

    def observe(self, reg=None, **labels) -> None:
        """Publish this ledger into a metrics registry (the default one
        when `reg` is None): per-channel sends, wire bytes and f32 words
        as labeled counters (`repro_torch.obs.observe_ledger`)."""
        from ..obs import observe_ledger
        observe_ledger(self, reg, **labels)

    def __repr__(self) -> str:
        chans = ", ".join(f"{c.name}:{c.sends}x{c.bytes_per_send}B"
                          for c in self.channels.values())
        return f"CommLedger({self.name}, {chans}, total={self.total_bytes}B)"


def static_ledger(spec: str, channels, name: str = "comm") -> CommLedger:
    """Ledger from (name, payload_shape, sends) triples, all on one
    compressor spec — the config-level preview used by
    `DAGMConfig.comm_ledger`."""
    policy = parse_comm_spec(spec)
    led = CommLedger(name)
    for ch_name, shape, sends in channels:
        led.register(ch_name, shape, policy)
        led.charge(ch_name, sends)
    return led
