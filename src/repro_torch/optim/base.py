"""Functional optimizer interface. Port of ``repro/optim/base.py``.

An optimizer is a pair of functions over ordered ``{path: tensor}`` dicts
(see ``repro_torch.core.layout``):
  * ``init(params) -> state``
  * ``update(grads, state, params, step, aux=None, inplace=False)
    -> (updates, new_state)``
where ``updates`` are additive deltas and ``step`` is a host int. ``aux``
carries what a wrapper hands the optimizer it wraps: the delay FIFO's stale
weight snapshot, ``{"stale_params": {path: tensor}}``, which delay
compensation reads. Every optimizer takes the keyword; the others ignore it.

``inplace`` is the port of the reference's donated step
(``repro/engine/spmd.py``, ``donate_argnums``). By default ``update`` is
functional, the reference's shape: ``state`` and its tensors are left as
they were and ``new_state`` is built anew. With ``inplace=True`` it may
write the new state into the tensors of ``state`` and then returns that
same ``state`` object; the caller must not read the old values afterwards.
Both forms compute every value with the same expressions, so they agree
bitwise; the in-place form holds at most one leaf's transient beside the
state instead of a second copy of it.

Schedules and bias corrections are computed on the host in float32, as the
reference computes them on the device in float32, and reach the tensor math
as Python floats that float32 represents exactly: no device value is ever
read back on the hot path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]
f32 = np.float32


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[..., Tuple[Params, Any]]  # (grads, state, params, step, aux=None)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """params += updates, in place: the parameters are the model's own."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))
    return params


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


def clip_by_global_norm(grads: Params, max_norm: float, inplace: bool = True,
                        norm: Optional[torch.Tensor] = None) -> Params:
    """Scale ``grads`` so their global norm is at most ``max_norm``, in
    their own tensors (the caller's step owns them: no copy of the
    gradients is made) and the same dict returned; or, without ``inplace``,
    into new tensors (the same bits), leaving ``grads`` as they were.
    ``norm`` is the global norm when ``grads`` are only part of the
    gradient (one process's slab); by default that of ``grads``."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    if not inplace:
        return {k: g * scale for k, g in grads.items()}
    for g in grads.values():
        g.mul_(scale)
    return grads


def ema(old: torch.Tensor, new: torch.Tensor, beta: float, inplace: bool) -> torch.Tensor:
    """``beta * old + (1 - beta) * new``, written over ``old`` when
    ``inplace`` (the same operations, so the same bits either way)."""
    return torch.add(beta * old, (1 - beta) * new, out=old if inplace else None)


def constant_schedule(lr: float) -> Schedule:
    return lambda step: float(f32(lr))


def warmup_cosine_schedule(lr: float, total_steps: int, warmup_frac: float = 0.012) -> Schedule:
    warmup = max(1, int(total_steps * warmup_frac))

    def schedule(step: int) -> float:
        s = f32(step)
        warm = f32(lr) * (s + f32(1)) / f32(warmup)
        progress = np.clip((s - f32(warmup)) / f32(max(1, total_steps - warmup)),
                           f32(0), f32(1))
        cos = f32(lr * 0.5) * (f32(1) + np.cos(f32(np.pi) * progress))
        return float(warm if s < warmup else cos)

    return schedule


def make_schedule(name: str, lr: float, total_steps: int, warmup_frac: float) -> Schedule:
    if name == "cosine":
        return warmup_cosine_schedule(lr, total_steps, warmup_frac)
    return constant_schedule(lr)


def bias_correction(beta: float, step: int) -> float:
    """1 - beta^(step+1) in float32."""
    return float(f32(1) - f32(beta) ** (f32(step) + f32(1)))
