"""Adam / AdamW baseline. Port of ``repro/optim/adam.py::adam``; the other
baselines there (AdaSGD, async Nesterov) are not ported yet."""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer, Schedule, bias_correction


def adam(
    schedule: Schedule,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        return {
            "m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        }

    def update(grads, state, params, step):
        lr = schedule(step)
        bc1, bc2 = bias_correction(beta1, step), bias_correction(beta2, step)
        m = {k: beta1 * state["m"][k] + (1 - beta1) * g.float() for k, g in grads.items()}
        v = {k: beta2 * state["v"][k] + (1 - beta2) * torch.square(g.float())
             for k, g in grads.items()}
        updates = {}
        for k, p in params.items():
            u = -lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
            if weight_decay:
                u = u - lr * weight_decay * p.detach().float()
            updates[k] = u
        return updates, {"m": m, "v": v}

    return Optimizer(init, update)
