"""Delay-aware baselines: PipeDream-LR (stage-wise learning-rate scheduling,
Yang et al. 2021), Delay Compensation (Zheng et al. 2017, Fig. 19) and the
Nesterov async-PP optimizer (Ajanthan et al. 2025, arXiv:2505.01099). Port
of ``repro/optim/delay_aware.py``.

PipeDream-LR and Nesterov async-PP take per-leaf total delays
(``StageContext.delay_scales``): an int for a leaf owned by one stage, a
``(K, 1, ..., 1)`` float32 tensor over a stage-stacked leaf's leading axis,
so each stage slice of a stacked leaf gets its own factor. The factors are
computed once, in float32 as the reference computes them; a tensor factor is
copied to the device of the leaf it multiplies at its first use (the SPMD
engine builds its optimizer from weightless meta-device shapes) and kept
there. Delay Compensation reads the stale weight snapshot the delay FIFO
queues (``aux={"stale_params": ...}``); under the stacked layout that
snapshot is already each stage's own, so the same elementwise formula
applies per stage slice.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Union

import torch

from repro_torch.optim.adam import _moments, _new_state, _zeros, adam
from repro_torch.optim.base import Optimizer, Schedule, bias_correction

Factor = Union[float, torch.Tensor]


def _per_leaf(delays: Sequence[Union[int, torch.Tensor]],
              fn: Callable[[torch.Tensor], torch.Tensor]) -> List[Factor]:
    """``fn`` of each leaf's total delay, in float32: a float for an int
    delay, a tensor for a per-stage one."""
    out: List[Factor] = []
    for d in delays:
        if isinstance(d, torch.Tensor):
            out.append(fn(d.to(torch.float32)))
        else:
            out.append(float(fn(torch.tensor(float(d), dtype=torch.float32))))
    return out


def _placed(factors: List[Factor], i: int, like: torch.Tensor) -> Factor:
    """Factor i on ``like``'s device, copied there once."""
    f = factors[i]
    if isinstance(f, torch.Tensor) and f.device != like.device:
        f = factors[i] = f.to(like.device)
    return f


def pipedream_lr(
    schedule: Schedule,
    delays,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    power: float = 0.5,
) -> Optimizer:
    """Adam with a per-stage learning-rate discount lr_k = lr / (1 + tau_k)^power.

    ``delays``: per-leaf values in leaf order, each broadcastable over its
    leaf (ints, or ``(K, 1, ..., 1)`` tensors for stage-stacked leaves)."""
    inner = adam(schedule, beta1, beta2, eps)
    scales = _per_leaf(delays, lambda t: (1.0 + t) ** (-power))

    def update(grads, state, params, step, aux=None, inplace=False):
        updates, state = inner.update(grads, state, params, step, inplace=inplace)
        # the inner updates are this step's own tensors: discounted where they lie
        for i, u in enumerate(updates.values()):
            u.mul_(_placed(scales, i, u))
        return updates, state

    return Optimizer(inner.init, update)


def nesterov_pp(
    schedule: Schedule,
    delays,
    beta1: float = 0.99,
    beta2: float = 0.999,
    eps: float = 1e-8,
) -> Optimizer:
    """Delay-aware Nesterov look-ahead for asynchronous pipeline parallelism
    (Ajanthan et al. 2025): the momentum is extrapolated tau + 1
    applications ahead, which in the EMA geometry is the closed form

        n_t = beta1^(tau+1) * m_t + (1 - beta1^(tau+1)) * g_t

    At tau = 0 this is ``nesterov_adam``; the second moment and the bias
    corrections are Adam's. ``delays``: per-leaf total delays, as for
    ``pipedream_lr``."""
    look = _per_leaf(delays, lambda t: torch.pow(torch.tensor(beta1, dtype=torch.float32),
                                                 1.0 + t))

    def init(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def update(grads, state, params, step, aux=None, inplace=False):
        lr = schedule(step)
        bc1, bc2 = bias_correction(beta1, step), bias_correction(beta2, step)
        m, v = _moments(grads, state, beta1, beta2, inplace)
        updates = {}
        for i, (k, g) in enumerate(grads.items()):
            lk = _placed(look, i, g)
            updates[k] = (-lr * ((lk * m[k] + (1.0 - lk) * g.float()) / bc1)
                          / (torch.sqrt(v[k] / bc2) + eps))
        return updates, _new_state(state, inplace, m=m, v=v)

    return Optimizer(init, update)


def delay_compensation(
    schedule: Schedule,
    lam: float = 0.1,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
) -> Optimizer:
    """First-order Taylor compensation of stale gradients, then Adam:

        g_hat = g + lam * g * g * (w_t - w_{t-tau})

    The diagonal empirical Fisher g*g stands in for the Hessian. The stale
    weights come as ``aux={"stale_params": {path: tensor}}`` from a delay
    wrapper built with ``store_params=True``; without them the gradient is
    used as it is."""
    inner = adam(schedule, beta1, beta2, eps)

    def update(grads, state, params, step, aux=None, inplace=False):
        if aux is not None and "stale_params" in aux:
            stale = aux["stale_params"]
            grads = {k: g + lam * g * g * (params[k].float() - stale[k].float())
                     for k, g in grads.items()}
        return inner.update(grads, state, params, step, inplace=inplace)

    return Optimizer(inner.init, update)
