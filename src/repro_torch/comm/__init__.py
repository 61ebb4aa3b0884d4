"""repro_torch.comm — gossip compressors, error feedback and the byte
ledger.

Counterpart of `repro.comm`: `parse_comm_spec` (identity, bf16, int8,
int4, top-k, rand-k, each optionally with error feedback),
`row_quant_params` (bitwise the reference's wire metadata), the
`ChannelState` threaded through the round loops, and the byte-accurate
`CommLedger`.
"""
from .compressors import (BF16_BYTES, F32_BYTES, QUANT_META_BYTES,
                          Bf16Compressor, CommPolicy, Compressor,
                          RandKCompressor, StochasticQuantCompressor,
                          TopKCompressor, make_compressor,
                          parse_comm_spec, row_quant_params)
from .feedback import (ChannelState, JobChannelState, channel_init,
                       channel_seeds, compressed_payload,
                       compressed_payload_local, fold_seed, open_channels,
                       send_seed, stack_channels)
from .ledger import Channel, CommLedger, static_ledger

__all__ = [
    "BF16_BYTES", "Bf16Compressor", "Channel", "ChannelState",
    "CommLedger", "CommPolicy", "Compressor", "F32_BYTES",
    "JobChannelState", "compressed_payload_local", "fold_seed",
    "QUANT_META_BYTES", "RandKCompressor", "StochasticQuantCompressor",
    "TopKCompressor", "channel_init", "channel_seeds",
    "compressed_payload", "make_compressor", "open_channels",
    "parse_comm_spec", "row_quant_params", "send_seed", "stack_channels",
    "static_ledger",
]
