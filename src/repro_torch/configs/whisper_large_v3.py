"""whisper-large-v3 [audio] — encoder-decoder; mel+conv frontend is a
STUB (input_specs provides frame embeddings). [arXiv:2212.04356]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio", citation="arXiv:2212.04356",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866, encoder_decoder=True, encoder_layers=32,
    encoder_frames=1500,
)
