from repro_torch.optim.adam import adam, adasgd, nesterov_adam
from repro_torch.optim.base import (
    Optimizer,
    apply_updates,
    bias_correction,
    clip_by_global_norm,
    constant_schedule,
    global_norm,
    make_schedule,
    warmup_cosine_schedule,
)
from repro_torch.optim.delay_aware import delay_compensation, pipedream_lr

__all__ = [
    "adam",
    "adasgd",
    "nesterov_adam",
    "Optimizer",
    "apply_updates",
    "bias_correction",
    "clip_by_global_norm",
    "constant_schedule",
    "global_norm",
    "make_schedule",
    "warmup_cosine_schedule",
    "delay_compensation",
    "pipedream_lr",
]
