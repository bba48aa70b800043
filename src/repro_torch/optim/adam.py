"""Adam / AdamW / AdaSGD / async-Nesterov baselines. Port of
``repro/optim/adam.py``.

AdaSGD (Wang & Wiens 2020) applies one global adaptive scale: the paper uses
it (Fig. 3) to show that coordinate-wise adaptivity, not adaptivity per se,
is what basis misalignment breaks.

The Nesterov baseline follows Ajanthan et al. (2025): Adam with a Nesterov
look-ahead on the first moment (beta1 = 0.99 in the paper's setup).
"""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer, Schedule, bias_correction, ema


def _zeros(params):
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def _moments(grads, state, beta1: float, beta2: float, inplace: bool):
    """Adam's first and second moments after this step's gradients; with
    ``inplace`` written over the state's own tensors."""
    m = {k: ema(state["m"][k], g.float(), beta1, inplace) for k, g in grads.items()}
    v = {k: ema(state["v"][k], torch.square(g.float()), beta2, inplace)
         for k, g in grads.items()}
    return m, v


def _new_state(state, inplace: bool, **new):
    """The state after an update: ``state`` itself when updated in place
    (its tensors already hold the new values), else a new dict."""
    return state if inplace else new


def adam(
    schedule: Schedule,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def update(grads, state, params, step, aux=None, inplace=False):
        lr = schedule(step)
        bc1, bc2 = bias_correction(beta1, step), bias_correction(beta2, step)
        m, v = _moments(grads, state, beta1, beta2, inplace)
        updates = {}
        for k, p in params.items():
            u = -lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
            if weight_decay:
                u = u - lr * weight_decay * p.detach().float()
            updates[k] = u
        return updates, _new_state(state, inplace, m=m, v=v)

    return Optimizer(init, update)


def adasgd(
    schedule: Schedule,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
) -> Optimizer:
    """Single global adaptive scale: ``v`` is one float32 scalar, the EMA of
    the mean squared gradient over every element of every leaf."""

    def init(params):
        p0 = next(iter(params.values()))
        return {"m": _zeros(params), "v": torch.zeros((), dtype=torch.float32, device=p0.device)}

    def update(grads, state, params, step, aux=None, inplace=False):
        lr = schedule(step)
        bc1, bc2 = bias_correction(beta1, step), bias_correction(beta2, step)
        n_total = sum(g.numel() for g in grads.values())
        # summed leaf by leaf in leaf order, as the reference sums
        sq_mean = sum(torch.sum(torch.square(g.float())) for g in grads.values()) / n_total
        v = ema(state["v"], sq_mean, beta2, inplace)
        denom = torch.sqrt(v / bc2) + eps
        m = {k: ema(state["m"][k], g.float(), beta1, inplace) for k, g in grads.items()}
        updates = {k: -lr * (mm / bc1) / denom for k, mm in m.items()}
        return updates, _new_state(state, inplace, m=m, v=v)

    return Optimizer(init, update)


def nesterov_adam(
    schedule: Schedule,
    beta1: float = 0.99,
    beta2: float = 0.999,
    eps: float = 1e-8,
) -> Optimizer:
    """Adam with a Nesterov-style look-ahead momentum (Ajanthan et al., 2025):
    the step uses one more momentum application than the state keeps."""

    def init(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def update(grads, state, params, step, aux=None, inplace=False):
        lr = schedule(step)
        bc1, bc2 = bias_correction(beta1, step), bias_correction(beta2, step)
        m, v = _moments(grads, state, beta1, beta2, inplace)
        updates = {k: -lr * ((beta1 * m[k] + (1 - beta1) * g.float()) / bc1)
                   / (torch.sqrt(v[k] / bc2) + eps) for k, g in grads.items()}
        return updates, _new_state(state, inplace, m=m, v=v)

    return Optimizer(init, update)
