"""repro_torch.comm — the gossip wire (identity) and its byte ledger.

Counterpart of `repro.comm` for the identity wire: `parse_comm_spec`,
`ChannelState` with its send counter, and the byte-accurate
`CommLedger`.  Lossy compressors are ROADMAP queue 1 item 5.
"""
from .compressors import (F32_BYTES, CommPolicy, Compressor,
                          make_compressor, parse_comm_spec)
from .feedback import ChannelState, channel_init, open_channels
from .ledger import Channel, CommLedger, static_ledger

__all__ = [
    "Channel", "ChannelState", "CommLedger", "CommPolicy", "Compressor",
    "F32_BYTES", "channel_init", "make_compressor", "open_channels",
    "parse_comm_spec", "static_ledger",
]
