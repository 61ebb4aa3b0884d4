"""chameleon-34b [vlm] — early-fusion, VQ image tokens share the text
vocab; backbone is a plain token decoder (frontend stubbed).
[arXiv:2405.09818]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm", citation="arXiv:2405.09818",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=65536, qk_norm=True,
)
