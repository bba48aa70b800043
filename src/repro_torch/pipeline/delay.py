"""Deterministic gradient-staleness wrappers (weight-stashing semantics).
Port of ``repro/pipeline/delay.py``: ``delayed_optimizer`` (per-leaf delays)
and ``stage_delayed_optimizer`` (the SPMD stage-stacked layout).

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

from typing import Sequence, Union

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


def stage_delayed_optimizer(inner: Optimizer, specs: Sequence[Union[int, str]],
                            num_stages: int, store_params: bool = False) -> Optimizer:
    """Delay wrapper for the stage-stacked layout.

    ``specs`` is per leaf: an int delay (shared leaves, as in
    ``delayed_optimizer``) or ``"stage"`` for a leaf whose leading axis is
    the pipeline stage (``StageContext.delay_specs``). A ``"stage"`` leaf of
    shape (K, ...) keeps the last K-1 full gradients; stage k applies the
    one from tau_k = K-1-k steps ago, its own slice of it: the reference's
    diagonal read ``q[k, k]`` of a queue whose row 0 is the oldest. The last
    stage applies the fresh gradient. During warm-up (t < tau_k) stage k
    receives zeros.

    Both kinds of queue are ring buffers advanced by one head counter, as in
    ``delayed_optimizer``; logical row r of a depth-d queue is slot
    ``(head + r) % d``. ``store_params=True`` (stale-weight snapshots for
    delay compensation) is not ported yet.
    """
    if store_params:
        raise NotImplementedError(
            "not yet ported: store_params (delay_compensation's stale weights)")
    K = int(num_stages)
    specs = list(specs)

    def depth(s) -> int:
        return K - 1 if s == "stage" else int(s)

    def init(params):
        if len(params) != len(specs):
            raise ValueError("delay-spec list must match leaf count")
        queues = [
            torch.zeros((depth(s),) + tuple(p.shape), dtype=torch.float32, device=p.device)
            if depth(s) > 0 else None
            for p, s in zip(params.values(), specs)
        ]
        return {"inner": inner.init(params), "grad_q": queues, "head": 0}

    def update(grads, state, params, step):
        head = state["head"]
        delayed = {}
        for (k, g), q, s in zip(grads.items(), state["grad_q"], specs):
            if q is None:
                delayed[k] = g
            elif s == "stage":
                d = K - 1
                # stage j reads logical row j (pushed d - j steps ago), slice j
                delayed[k] = torch.stack(
                    [q[(head + j) % d, j] for j in range(d)] + [g[d].float()])
            else:
                delayed[k] = q[head % q.shape[0]]
        updates, inner_state = inner.update(delayed, state["inner"], params, step)
        with torch.no_grad():
            for g, q in zip(grads.values(), state["grad_q"]):
                if q is not None:
                    q[head % q.shape[0]].copy_(g)  # the oldest slot takes the fresh gradient
        return updates, {"inner": inner_state, "grad_q": state["grad_q"], "head": head + 1}

    return Optimizer(init, update)
