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
leaves (every leaf pushes once per step), written in place when the update
is (``inplace``, the donated step) and in a copy otherwise: at paper_95m
with 8 stages the queues hold about 1.3 GB of float32.

``store_params=True`` also queues weight snapshots, so that delay
compensation (Zheng et al. 2017) sees w_{t-tau}: rings of the same depths
advanced by the same head, warm-started with copies of the initial weights
(during warm-up the stale weights are the initial ones). A slot is written
with ``copy_``: the parameters change in place, so a slot must never be a
view of one. The stale snapshot reaches the wrapped optimizer as
``aux={"stale_params": {path: tensor}}``.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from repro_torch.optim.base import Optimizer


def _warm_ring(p: torch.Tensor, depth: int):
    """A ring of ``depth`` copies of ``p`` in float32, or None."""
    if depth <= 0:
        return None
    return p.detach().float().unsqueeze(0).repeat((depth,) + (1,) * p.ndim)


def _push(queues, fresh, head: int, inplace: bool):
    """Each ring's oldest slot takes its leaf's fresh value: in the ring
    itself with ``inplace``, else in a copy of it (the rings handed in stay
    as they were). Returns the rings."""
    if not inplace:
        queues = [None if q is None else q.clone() for q in queues]
    with torch.no_grad():
        for x, q in zip(fresh.values(), queues):
            if q is not None:
                q[head % q.shape[0]].copy_(x)
    return queues


def _wrapped_update(inner: Optimizer, pop, store_params: bool):
    """The wrappers' update: pop each leaf's delayed gradient (and stale
    weights) with ``pop(leaves, queues, head)``, run ``inner``, then push the
    fresh values into the slots just popped. ``inner`` is handed ``aux``
    only when there is any: an optimizer that reads no aux need not take
    it. With ``inplace`` the inner state and the rings are updated in their
    own tensors and the same state dict is returned; without it the rings
    are copied, so the state handed in is left as it was."""

    def update(grads, state, params, step, aux=None, inplace=False):
        head = state["head"]
        if store_params:
            aux = {**(aux or {}), "stale_params": pop(params, state["param_q"], head)}
        delayed = pop(grads, state["grad_q"], head)
        kw = {"aux": aux} if aux else {}
        updates, inner_state = inner.update(delayed, state["inner"], params, step,
                                            inplace=inplace, **kw)
        new_state = state if inplace else dict(state)
        new_state.update(inner=inner_state, head=head + 1)
        for name, fresh in (("grad_q", grads), ("param_q", params)):
            if name in state:
                new_state[name] = _push(state[name], fresh, head, inplace)
        return updates, new_state

    return update


def delayed_optimizer(inner: Optimizer, delays: Sequence[int],
                      store_params: bool = False) -> Optimizer:
    """Wrap ``inner`` so each leaf's gradient is applied tau steps late.

    ``delays``: per-leaf ints in the parameter dict's leaf order. ``inner``
    must not keep references to the gradients (or stale weights) it is
    given: the slot they are read from is overwritten once ``inner``
    returns.
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
        state = {"inner": inner.init(params), "grad_q": queues, "head": 0}
        if store_params:
            state["param_q"] = [_warm_ring(p, d) for p, d in zip(params.values(), delays)]
        return state

    def pop(leaves, queues, head):
        # slot head % d holds the value pushed d steps ago: pop it
        return {k: x if d == 0 else q[head % d]
                for (k, x), q, d in zip(leaves.items(), queues, delays)}

    return Optimizer(init, _wrapped_update(inner, pop, store_params))


def stage_delayed_optimizer(inner: Optimizer, specs: Sequence[Union[int, str]],
                            num_stages: int, store_params: bool = False,
                            extra_param_delay: int = 0, stage_offset: int = 0) -> Optimizer:
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
    ``(head + r) % d``. ``store_params=True`` queues weight snapshots with
    the same reads, so stage k sees its own w_{t-tau_k} and the last stage
    the live weights.

    ``extra_param_delay=E`` (the asynchronous data axis, whose engine
    applies a reduction E steps old to every gradient) deepens only the
    weight queues, to (K-1)+E for stage leaves and s+E for shared ones, so
    that stage k reads w_{t-(tau_k+E)}: logical row k of its ring, for
    every stage once E >= 1 (even the last reads a queued snapshot). The
    gradient queues keep pipeline depth.

    ``stage_offset=k0`` is a process's slab of the stages (a multi-process
    run): its ``"stage"`` leaves are ``(n, ...)`` for global stages
    ``k0 .. k0+n-1``, and slab position j reads what global stage k0 + j
    reads, logical row k0 + j of a ring of the same depth K-1, the
    reference's per-device slice ``(K-1, 1, ...)`` of its stage queues.
    """
    K = int(num_stages)
    E = int(extra_param_delay)
    k0 = int(stage_offset)
    if E < 0:
        raise ValueError(f"extra_param_delay must be >= 0, got {E}")
    if not 0 <= k0 < K:
        raise ValueError(f"stage_offset must be in [0, {K}), got {k0}")
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
        state = {"inner": inner.init(params), "grad_q": queues, "head": 0}
        if store_params:
            state["param_q"] = [_warm_ring(p, depth(s) + E)
                                for p, s in zip(params.values(), specs)]
        return state

    def pop(leaves, queues, head):
        # a ring's depth is its own: K-1 (+E for weights) for stage leaves
        out = {}
        for (k, x), q, s in zip(leaves.items(), queues, specs):
            if q is None:
                out[k] = x
            elif s == "stage":
                d, n = q.shape[0], x.shape[0]
                # global stage k0 + j reads logical row k0 + j (pushed
                # d - k0 - j steps ago), slab slice j; at depth K-1 the last
                # stage reads the fresh value
                rows = [q[(head + k0 + j) % d, j] for j in range(min(d - k0, n))]
                out[k] = torch.stack(rows + ([x[d - k0].float()] if d - k0 < n else []))
            else:
                out[k] = q[head % q.shape[0]]
        return out

    return Optimizer(init, _wrapped_update(inner, pop, store_params))
