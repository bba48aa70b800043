"""Simulation backend: the paper's virtual-stage setup behind the engine API.
Port of ``repro/engine/sim.py``: it wraps
``pipeline.simulate.make_sim_train_step`` in its three modes (weight
stashing through the optimizer's delay FIFO, weight prediction, no stash)
and owns the no-stash window of stale parameter snapshots.

The model's parameters are the engine's: every step and every restore
changes them in place, so the step built once keeps reading the live
tensors. So does the optimizer state, with no switch: each step writes it
into its own tensors (``Optimizer.update(..., inplace=True)``), which is
the port of the reference's donated step. The reference's sim step does
not donate, so that a caller's initial parameters survive; here
``init_state`` and ``load_state`` never hand out a tensor the caller owns
(the state is built fresh by ``optimizer.init``, the parameters are the
engine's model), which keeps the same guarantee.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint.convert import (
    copy_params_from_numpy,
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_to_numpy,
)
from repro_torch.engine.base import EngineState, PipelineEngine
from repro_torch.models.model import Transformer, param_leaves
from repro_torch.optim.base import Optimizer, Schedule
from repro_torch.pipeline.simulate import make_sim_train_step, stale_forward_params


class SimEngine(PipelineEngine):
    name = "sim"

    def __init__(self, model: Transformer, optimizer: Optimizer, grad_clip: float = 1.0,
                 weight_prediction: bool = False,
                 delays_tree: Optional[Dict[str, int]] = None,
                 schedule: Optional[Schedule] = None, no_stash: bool = False):
        self.model = model
        self.optimizer = optimizer
        self.delays_tree = delays_tree
        self.no_stash = no_stash
        self.device = next(model.parameters()).device
        self._step_fn = make_sim_train_step(model, optimizer, grad_clip, weight_prediction,
                                            delays_tree, schedule, no_stash)
        self.max_age = 0
        if no_stash and delays_tree is not None:
            self.max_age = max(int(d) for d in delays_tree.values())

    def init_state(self) -> EngineState:
        params = param_leaves(self.model)
        return EngineState(params=params, opt_state=self.optimizer.init(params))

    def step(self, state: EngineState, batch: Dict, t: int) -> Tuple[EngineState, Any, Dict]:
        fwd_hist = (stale_forward_params(state.history, state.params, self.delays_tree)
                    if self.no_stash else None)
        opt_state, loss, metrics = self._step_fn(state.opt_state, fwd_hist, batch, t)
        history = state.history
        if self.no_stash and self.max_age:
            # the parameters change in place: the window keeps copies
            with torch.no_grad():
                snap = {k: p.detach().clone() for k, p in state.params.items()}
            history = (history + [snap])[-(self.max_age + 1):]
        return EngineState(state.params, opt_state, history), loss, metrics

    def checkpoint_tree(self, state: EngineState) -> Any:
        return (params_to_numpy(self.model), opt_state_to_numpy(state.opt_state))

    def load_state(self, tree: Any) -> EngineState:
        params_tree, opt_tree = tree
        params = param_leaves(self.model)
        copy_params_from_numpy(params, params_tree)
        return EngineState(params, opt_state_from_numpy(opt_tree, self.optimizer.init(params)))
