"""minitron-8b [dense] — pruned nemotron, GQA. [arXiv:2407.14679]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense", citation="arXiv:2407.14679",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256000,
)
