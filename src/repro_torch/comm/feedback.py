"""Gossip channel state — the identity-wire part of `repro.comm.feedback`.

`ChannelState` is threaded through the round loops of
`repro_torch.core.dagm`, one per gossip channel.  Its `sends` counter is
a host integer, bumped once per exchange, which `CommLedger
.charge_states` reads back after the run, so byte accounting reflects
the exchanges that actually ran.  The error-feedback replica `hat`
exists for the lossy compressors of ROADMAP queue 1 item 5 (which also
bring the per-channel random streams); on the identity wire it stays
None.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .compressors import CommPolicy


@dataclasses.dataclass
class ChannelState:
    """State of one gossip channel.

    hat:   EF replica of the gossiped variable (None without EF).
    sends: gossip exchanges so far.
    name:  channel label (ledger key).
    """
    hat: Any
    sends: int
    name: str = "channel"

    def bump(self) -> "ChannelState":
        return dataclasses.replace(self, sends=self.sends + 1)

    def reset_hat(self) -> "ChannelState":
        """Reopen the channel for a fresh variable (the DIHGP h vector,
        re-initialized every outer round): neighbors' replicas restart
        at zero, the send counter continues."""
        hat = None if self.hat is None else torch.zeros_like(self.hat)
        return dataclasses.replace(self, hat=hat)


def channel_init(policy: CommPolicy, name: str, x) -> ChannelState:
    """Open a gossip channel for the stacked (n, ...) template `x`."""
    hat = torch.zeros_like(x) if policy.ef else None
    return ChannelState(hat=hat, sends=0, name=name)


def open_channels(op, templates: dict) -> dict:
    """One ledger-registered channel per {name: template} on a
    MixingOp."""
    return {name: op.comm_channel(name, x) for name, x in templates.items()}
