"""Single-program simulation of asynchronous pipeline-parallel training.
Port of ``repro/pipeline/simulate.py``: the delay pattern of a K-stage
PipeDream pipeline is imposed exactly by the per-leaf gradient FIFO inside
the optimizer, while compute runs as one program.

Modes:
  * weight stashing (default): gradient FIFO == stashed-weight semantics.
  * weight prediction (PipeMare, Yang et al. 2021): the forward pass runs on
    weights extrapolated tau steps ahead using the optimizer's momentum.
  * no stashing (Gaunt et al. 2017): forward activations and backward
    linearisation use *different* weight versions per stage, so the
    gradient is not the gradient of any single point. Each block runs its
    forward on the stale version and is differentiated at the current one
    (``_TwoVersionBlock``).

Parameters travel as the model's ``{path: parameter}`` dict, which the
steps update in place, as they do the optimizer state.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.func import functional_call

from repro_torch.core.rotation import rotate, unrotate
from repro_torch.models.model import (
    Transformer,
    cross_entropy,
    embed,
    head_logits,
    loss_fn,
    param_leaves,
    shared_leaves,
)
from repro_torch.optim.base import Optimizer, Schedule, apply_updates, clip_by_global_norm

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# PipeMare-style weight prediction
# ---------------------------------------------------------------------------


def _find_moments(opt_state: Any) -> Optional[Dict]:
    """Locate Adam-style (m, v) in possibly-wrapped optimizer state."""
    if isinstance(opt_state, dict):
        if "m" in opt_state and "v" in opt_state:
            return {"m": opt_state["m"], "v": opt_state["v"]}
        if "inner" in opt_state:
            return _find_moments(opt_state["inner"])
        if "leaves" in opt_state:
            return {"leaves": opt_state["leaves"]}
    return None


@torch.no_grad()
def predict_weights(params: Params, opt_state: Any, delays: Dict[str, int], lr: float,
                    eps: float = 1e-8) -> Params:
    """w_hat = w - lr * tau * m / (sqrt(v) + eps): extrapolate tau steps ahead.

    For basis-rotation state the momentum ``m`` lives in the original space
    but the second moment ``v`` in the rotated one, so the ratio is formed
    there: rotate m into the eigenbasis, divide by sqrt(v) and rotate the
    step back, as the optimizer's own update does. Leaves with tau = 0 are
    returned as they are."""
    mo = _find_moments(opt_state)
    if mo is None:
        return params
    out = {}
    if "leaves" in mo:  # basis-rotation state: a list in leaf order
        for (k, p), st in zip(params.items(), mo["leaves"]):
            d = int(delays[k])
            if d <= 0:
                out[k] = p
                continue
            U, V = st.get("U"), st.get("V")
            if U is not None or V is not None:
                m_rot = rotate(st["m"], U, V)
                step = unrotate(m_rot / (torch.sqrt(st["v"]) + eps), U, V)
            else:
                step = st["m"] / (torch.sqrt(st["v"]) + eps)
            out[k] = (p - lr * d * step).to(p.dtype)
        return out
    for k, p in params.items():
        d = int(delays[k])
        m, v = mo["m"][k], mo["v"][k]
        out[k] = (p - lr * d * m / (torch.sqrt(v) + eps)).to(p.dtype)
    return out


@contextmanager
def _weights_swapped(params: Params, values: Params):
    """Run the body with each parameter holding ``values[k]``; restore after.
    Gradients must be taken inside: autograd reads the parameters' data when
    the backward runs."""
    saved = {}
    for k, p in params.items():
        if values[k] is not p:
            saved[k] = p.data
            p.data = values[k]
    try:
        yield
    finally:
        for k, data in saved.items():
            params[k].data = data


# ---------------------------------------------------------------------------
# No-stash two-version gradients
# ---------------------------------------------------------------------------


class _TwoVersionBlock(torch.autograd.Function):
    """y = block(pf, x) forward; vjp at (pb, x) backward (version mismatch).
    ``pb`` are the block's own parameters, passed so autograd routes their
    gradients; ``pf`` reach the forward through ``run_fwd``."""

    @staticmethod
    def forward(ctx, x, run_fwd, run_bwd, *pb):
        ctx.run_bwd = run_bwd
        ctx.save_for_backward(x, *pb)
        with torch.no_grad():
            return run_fwd(x)

    @staticmethod
    def backward(ctx, ct):
        x, *pb = ctx.saved_tensors
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            pb = [p.detach().requires_grad_() for p in pb]
            y = ctx.run_bwd(x, pb)
            grads = torch.autograd.grad(y, [x, *pb], ct)
        return (grads[0], None, None, *grads[1:])


def make_two_version_loss(model: Transformer) -> Callable:
    """``loss(params_fwd, batch)``: activations from ``params_fwd`` (a
    ``{path: tensor}`` dict of stale weights), backward linearisation at the
    model's own parameters, which carry the gradient. The embedding,
    position embedding, final norm and head use the model's parameters, as
    the reference's do."""
    cfg = model.cfg

    def block_fn(block, names):
        def run(x, weights):
            return functional_call(block, dict(zip(names, weights)), (x,))[0]
        return run

    def loss2w(params_fwd: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        shared = shared_leaves(model)
        x = embed(shared, cfg, batch["tokens"])
        for l, block in enumerate(model.blocks):
            named = [(n, p) for n, p in block.named_parameters()]
            names = [n for n, _ in named]
            pb = [p for _, p in named]
            pf = [params_fwd[f"blocks/{l}/{n.replace('.', '/')}"] for n in names]
            if all(f is b for f, b in zip(pf, pb)):  # same version: the plain block
                x, _ = block(x)
                continue
            run = block_fn(block, names)
            x = _TwoVersionBlock.apply(x, lambda xx, pf=pf, run=run: run(xx, pf), run, *pb)
        logits = head_logits(shared, cfg, x)
        return cross_entropy(logits, batch["labels"])

    return loss2w


# ---------------------------------------------------------------------------
# Train-step factory and the training run
# ---------------------------------------------------------------------------


def make_sim_train_step(
    model: Transformer,
    optimizer: Optimizer,
    grad_clip: float = 1.0,
    weight_prediction: bool = False,
    delays_tree: Optional[Dict[str, int]] = None,
    schedule: Optional[Schedule] = None,
    no_stash: bool = False,
) -> Callable:
    """``train_step(opt_state, fwd_hist, batch, step) -> (opt_state, loss,
    metrics)``. ``fwd_hist`` is the stale forward weights of no-stash mode
    (``stale_forward_params``), else unused.

    Updates the model's parameters, the step's gradients (clipping) and the
    optimizer state (``update(..., inplace=True)``, delay rings included)
    in place, and returns the same ``opt_state``: the caller must not keep
    the old state, and ``SimEngine`` never hands out one it does not own.
    The reference's sim step does not donate its buffers
    (``repro/pipeline/simulate.py``), so that callers may reuse their
    initial parameters; here the engine keeps that guarantee by owning
    what it changes. ``loss`` and ``metrics`` stay on the device, so the
    caller decides when to read them."""
    params = param_leaves(model)
    loss2w = make_two_version_loss(model) if no_stash else None
    predict = weight_prediction and delays_tree is not None and schedule is not None

    def grads_of(loss):
        return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    def train_step(opt_state, fwd_hist, batch: Dict[str, torch.Tensor], step: int) -> Tuple:
        if no_stash:
            # forward on stage-stale snapshots, backward on current params:
            # the version mismatch of stash-less PipeDream
            loss = loss2w(fwd_hist, batch)
            metrics = {"ce": loss, "aux": torch.zeros((), device=loss.device)}
            grads = grads_of(loss)
        elif predict:
            fwd = predict_weights(params, opt_state, delays_tree, schedule(step))
            with _weights_swapped(params, fwd):
                loss, metrics = loss_fn(model, batch)
                grads = grads_of(loss)
        else:
            loss, metrics = loss_fn(model, batch)
            grads = grads_of(loss)
        if grad_clip:
            grads = clip_by_global_norm(grads, grad_clip)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params, step, inplace=True)
            apply_updates(params, updates)
        return opt_state, loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return train_step


def stale_forward_params(history: List[Params], params: Params,
                         delays: Optional[Dict[str, int]]) -> Params:
    """Per-leaf stale parameters: the leaf on the stage with delay tau comes
    from the snapshot tau steps ago (its forward-time version).
    ``history[-1]`` is the current parameters (appended after the step), so
    the version from d steps ago is ``history[-1 - d]``."""
    if delays is None or not history:
        return params
    out = {}
    for k, p in params.items():
        age = min(int(delays[k]), len(history) - 1)
        out[k] = history[-1 - age][k] if age > 0 else p
    return out


def run_sim_training(
    model: Transformer,
    optimizer: Optimizer,
    data_iter,
    steps: int,
    grad_clip: float = 1.0,
    weight_prediction: bool = False,
    delays_tree: Optional[Dict[str, int]] = None,
    schedule: Optional[Schedule] = None,
    no_stash: bool = False,
    log_every: int = 0,
) -> Tuple[Params, Any, List[float]]:
    """Run ``steps`` simulated-async steps on ``model`` (trained in place);
    returns (params, opt_state, losses). A `SimEngine` driven by `run_loop`."""
    from repro_torch.engine.loop import LoopConfig, run_loop
    from repro_torch.engine.sim import SimEngine

    engine = SimEngine(model, optimizer, grad_clip, weight_prediction, delays_tree,
                       schedule, no_stash)
    state, losses, _ = run_loop(engine, data_iter, LoopConfig(steps=steps, log_every=log_every))
    return state.params, state.opt_state, losses
