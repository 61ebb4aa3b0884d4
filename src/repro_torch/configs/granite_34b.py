"""granite-34b [dense] — llama-arch code model, MQA (kv=1).
[arXiv:2405.04324]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense", citation="arXiv:2405.04324",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152,
)
