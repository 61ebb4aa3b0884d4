"""Model zoo: the assigned architectures' LMs on `nn.Module` parameter
trees (counterpart of `repro.models`): `loss`, `prefill`, `decode_step`
and greedy sampling, and the training step (`steps.make_train_step`) on
the plain tree `layers.param_tree` gives."""
from .model_zoo import Model, build_model

__all__ = ["Model", "build_model"]
