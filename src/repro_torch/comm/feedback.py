"""CHOCO-style error feedback and the gossip channel state — a torch
copy of `repro.comm.feedback`.

Every agent keeps `hat`, the replica of its own state that its
neighbors hold.  Each exchange transmits only the compressed innovation

    q   = C(x − hat)          (what crosses the wire)
    hat ← hat + q             (every endpoint applies the same update)

and the mixing consumes `hat`, so compression error does not compound.
Without EF the payload is simply C(x) and `hat` stays None.

`ChannelState` is threaded through the round loops of
`repro_torch.core.dagm`, one per gossip channel.  Its `sends` counter is
a host integer, bumped once per exchange, which `CommLedger
.charge_states` reads back after the run.  Its random stream is a host
integer too: the channel's `seed`, from which `send_seed(seed, sends)`
derives the int32 seed of each send — no generator state and no device
synchronization, and the same sequence on the CPU and the card.
`repro` splits a `jax.random` key per send instead; the two streams
differ, so the parity tests hand the port `repro`'s per-send seeds
through `MixingOp._next_seed`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils._pytree import tree_map

from .compressors import CommPolicy

_M32 = 0xFFFFFFFF
_INT32_MAX = 2 ** 31 - 1
# the channel streams' own fold constant, disjoint from y0's draw (as
# repro's `channel_keys` folds 0xC033 into the run's key)
_CHANNEL_FOLD = 0xC033


def _fmix32(x: int) -> int:
    """murmur3's 32-bit finalizer on a Python int."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    x ^= x >> 16
    return x


def channel_seeds(seed: int, names) -> dict:
    """{name: channel seed} for the run seed `seed`, one stream per
    channel (counterpart of `repro.comm.feedback.channel_keys`)."""
    run = _fmix32(_fmix32(seed) ^ _CHANNEL_FOLD)
    return {name: _fmix32(run + (i + 1) * 0x9E3779B9)
            for i, name in enumerate(names)}


def fold_seed(seed: int, data: int) -> int:
    """A new 32-bit stream from `seed` and a host integer `data` (a
    round, a leaf), the counterpart of `jax.random.fold_in`."""
    return _fmix32(_fmix32(seed) ^ _fmix32((data * 0x9E3779B9 + 1) & _M32))


def send_seed(channel_seed: int, send: int) -> int:
    """The kernel seed of the channel's `send`-th exchange, in
    [0, 2³¹ − 1) as `repro`'s `randint(0, int32 max)` draws it."""
    h = _fmix32(_fmix32(channel_seed ^ ((send * 0x85EBCA6B) & _M32)))
    return h % _INT32_MAX


@dataclasses.dataclass
class ChannelState:
    """State of one gossip channel.

    hat:   EF replica of the gossiped variable (None without EF): a
           tensor, or a tree of tensors on the sharded tier.
    sends: gossip exchanges so far.
    name:  channel label (ledger key).
    seed:  the channel's random stream (`send_seed`).
    """
    hat: Any
    sends: int
    name: str = "channel"
    seed: int = 0

    def bump(self) -> "ChannelState":
        return dataclasses.replace(self, sends=self.sends + 1)

    def reset_hat(self) -> "ChannelState":
        """Reopen the channel for a fresh variable (the DIHGP h vector,
        re-initialized every outer round): neighbors' replicas restart
        at zero, the send counter and the stream continue."""
        hat = None if self.hat is None \
            else tree_map(torch.zeros_like, self.hat)
        return dataclasses.replace(self, hat=hat)


def channel_init(policy: CommPolicy, name: str, x, seed: int = 0
                 ) -> ChannelState:
    """Open a gossip channel for the stacked (n, ...) template `x` (a
    tensor, or a tree of tensors on the sharded tier)."""
    hat = tree_map(torch.zeros_like, x) if policy.ef else None
    return ChannelState(hat=hat, sends=0, name=name, seed=int(seed))


def open_channels(op, templates: dict, seed: int = 0) -> dict:
    """One ledger-registered channel per {name: template} on a
    MixingOp, seeded by `channel_seeds(seed, ...)`."""
    seeds = channel_seeds(seed, list(templates))
    return {name: op.comm_channel(name, x, seeds[name])
            for name, x in templates.items()}


def compressed_payload(policy: CommPolicy, x, st: ChannelState,
                       seed: int | None = None):
    """Decoded message the neighbors receive for stacked x (n, ...),
    plus the advanced channel state.  `seed` is this send's seed
    (default `send_seed(st.seed, st.sends)`).  Identity short-circuits
    to the exact payload (the counter still bumps)."""
    if policy.is_identity:
        return x, st.bump()
    if seed is None:
        seed = send_seed(st.seed, st.sends)
    if policy.ef:
        payload = policy.compressor.roundtrip(x - st.hat, seed)
        # hat + C(x − hat), the sum in place where no gradient is taken
        payload = st.hat + payload if payload.requires_grad \
            else payload.add_(st.hat)
        hat = payload
    else:
        payload = policy.compressor.roundtrip(x, seed)
        hat = st.hat
    return payload, dataclasses.replace(st, hat=hat, sends=st.sends + 1)


def compressed_payload_local(policy: CommPolicy, leaf, hat_leaf, seed,
                             row: int = 0):
    """One agent's variant for the sharded tier's process ring: `leaf`
    is agent `row`'s own tensor (no stacked axis) and goes on the wire
    as one row, its stochastic draws those of row `row` of a stacked
    call.  Returns (payload, new hat leaf); the caller owns the seed and
    the send counter (one bump per exchange, not per leaf)."""
    if policy.is_identity:
        return leaf, hat_leaf
    if policy.ef:
        q = policy.compressor.roundtrip((leaf - hat_leaf)[None], seed,
                                        row=row)[0]
        payload = hat_leaf + q
        return payload, payload
    return policy.compressor.roundtrip(leaf[None], seed, row=row)[0], \
        hat_leaf


# ---------------------------------------------------------------------------
# A serve bucket's channels: one stream per job slot
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JobChannelState:
    """The gossip channel of a serve bucket of B job slots, the stacked
    twin of `ChannelState`: slot j carries job j's channel exactly as
    its solo run would.

    hat:   EF replicas, (n, B, ...) (None without EF).
    sends: (B,) int64 host array of exchanges per slot.
    seeds: (B,) host array of the slots' channel seeds (`send_seed`).
    """
    hat: Any
    sends: Any
    name: str = "channel"
    seeds: Any = None

    def bump(self) -> "JobChannelState":
        return dataclasses.replace(self, sends=self.sends + 1)

    def reset_hat(self) -> "JobChannelState":
        hat = None if self.hat is None else torch.zeros_like(self.hat)
        return dataclasses.replace(self, hat=hat)

    def send_seeds(self) -> list[int]:
        """Each slot's seed for its next send."""
        return [send_seed(int(s), int(k))
                for s, k in zip(self.seeds, self.sends)]

    def slot(self, j: int) -> ChannelState:
        """Slot j's channel as a solo `ChannelState`."""
        return ChannelState(hat=None if self.hat is None else self.hat[:, j],
                            sends=int(self.sends[j]), name=self.name,
                            seed=int(self.seeds[j]))


def stack_channels(states: list) -> JobChannelState:
    """Stack B solo `ChannelState`s of one channel into a bucket's
    `JobChannelState` (their hats along a new axis 1)."""
    import numpy as np
    first = states[0]
    hat = None if first.hat is None \
        else torch.stack([st.hat for st in states], dim=1).contiguous()
    return JobChannelState(
        hat=hat, sends=np.asarray([st.sends for st in states], np.int64),
        name=first.name,
        seeds=np.asarray([st.seed for st in states], np.int64))
