"""Single-program simulation of asynchronous pipeline-parallel training.
Port of ``repro/pipeline/simulate.py::make_sim_train_step`` in weight-stashing
mode: the delay pattern of a K-stage PipeDream pipeline is imposed exactly by
the per-leaf gradient FIFO inside the optimizer, while compute runs as one
program. Weight prediction and no-stash modes are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models.model import Transformer, loss_fn, param_leaves
from repro_torch.optim.base import Optimizer, apply_updates, clip_by_global_norm


def make_sim_train_step(
    model: Transformer, optimizer: Optimizer, grad_clip: float = 1.0
) -> Callable:
    """``train_step(opt_state, batch, step) -> (opt_state, loss, metrics)``.

    Updates the model's parameters in place; ``loss`` and ``metrics`` stay
    on the device, so the caller decides when to read them."""
    params = param_leaves(model)

    def train_step(opt_state, batch: Dict[str, torch.Tensor], step: int) -> Tuple:
        loss, metrics = loss_fn(model, batch)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if grad_clip:
            grads = clip_by_global_norm(grads, grad_clip)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params, step)
            apply_updates(params, updates)
        return opt_state, loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return train_step
