"""Model zoo: the assigned architectures' LMs on `nn.Module` parameter
trees (counterpart of `repro.models`), serving path: `loss` (forward),
`prefill`, `decode_step` and greedy sampling."""
from .model_zoo import Model, build_model

__all__ = ["Model", "build_model"]
