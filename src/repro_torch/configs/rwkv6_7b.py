"""rwkv6-7b [ssm] — Finch, attention-free, data-dependent decay.
[arXiv:2404.05892]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm", citation="arXiv:2404.05892",
    num_layers=32, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=14336, vocab_size=65536, attn_free=True, rwkv_head_size=64,
)
