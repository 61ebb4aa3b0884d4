"""repro_torch.checkpoint — tensor trees ⇄ atomic .npz steps, in the
layout of `repro.checkpoint` (the two packages read each other's
files)."""
from .checkpoint import (checkpoint_steps, latest_step, load_arrays,
                         prune_checkpoints, restore_checkpoint,
                         restore_into, save_checkpoint, sweep_stale)

__all__ = [
    "checkpoint_steps", "latest_step", "load_arrays",
    "prune_checkpoints", "restore_checkpoint", "restore_into",
    "save_checkpoint", "sweep_stale",
]
