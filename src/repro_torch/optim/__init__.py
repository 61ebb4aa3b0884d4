"""repro_torch.optim — optimizers and step-size schedules on tensor
trees (counterpart of `repro.optim`)."""
from .optimizers import (AdamWState, Optimizer, SGDState, adamw,
                         apply_updates, clip_by_global_norm,
                         constant_schedule, cosine_schedule, global_norm,
                         inverse_sqrt_schedule, power_schedule, sgd)

__all__ = ["AdamWState", "Optimizer", "SGDState", "adamw", "apply_updates",
           "clip_by_global_norm", "constant_schedule", "cosine_schedule",
           "global_norm", "inverse_sqrt_schedule", "power_schedule", "sgd"]
