"""Deterministic gradient-staleness wrapper (weight-stashing semantics).
Port of ``repro/pipeline/delay.py::delayed_optimizer``.

In PipeDream with weight stashing, the gradient applied at step t on stage k
was computed from the weights that stage held at step t - tau_k. A per-leaf
FIFO of gradients of depth tau_k reproduces this exactly: push the fresh
gradient, pop and apply the one from tau_k steps ago. During the first tau_k
steps the queue yields zeros, the pipeline warm-up.

The reference builds a new queue every step by concatenation. Here each
queue is a ring buffer of tau slots with one head counter shared by all
leaves (every leaf pushes once per step), updated in place: at paper_95m
with 8 stages the queues hold about 1.3 GB of float32.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.optim.base import Optimizer


def delayed_optimizer(inner: Optimizer, delays: Sequence[int]) -> Optimizer:
    """Wrap ``inner`` so each leaf's gradient is applied tau steps late.

    ``delays``: per-leaf ints in the parameter dict's leaf order. ``inner``
    must not keep references to the gradients it is given: the slot a
    delayed gradient is read from is overwritten once ``inner`` returns.
    """
    delays = [int(d) for d in delays]

    def init(params):
        if len(params) != len(delays):
            raise ValueError("delay list must match leaf count")
        queues = [
            torch.zeros((d,) + tuple(p.shape), dtype=torch.float32, device=p.device)
            if d > 0 else None
            for p, d in zip(params.values(), delays)
        ]
        return {"inner": inner.init(params), "grad_q": queues, "head": 0}

    def update(grads, state, params, step):
        head = state["head"]
        delayed = {}
        for (k, g), q, d in zip(grads.items(), state["grad_q"], delays):
            # slot head % d holds the gradient pushed d steps ago (zeros
            # during warm-up): pop it
            delayed[k] = g if d == 0 else q[head % d]
        updates, inner_state = inner.update(delayed, state["inner"], params, step)
        with torch.no_grad():
            for g, q, d in zip(grads.values(), state["grad_q"], delays):
                if d:
                    q[head % d].copy_(g)  # push into the slot just popped
        return updates, {"inner": inner_state, "grad_q": state["grad_q"], "head": head + 1}

    return Optimizer(init, update)
