from repro_torch.optim.adam import adam
from repro_torch.optim.base import (
    Optimizer,
    apply_updates,
    bias_correction,
    clip_by_global_norm,
    global_norm,
    make_schedule,
)

__all__ = [
    "adam",
    "Optimizer",
    "apply_updates",
    "bias_correction",
    "clip_by_global_norm",
    "global_norm",
    "make_schedule",
]
