"""Simulation backend: the paper's virtual-stage setup behind the engine API.
Port of ``repro/engine/sim.py`` in weight-stashing mode: it wraps
``pipeline.simulate.make_sim_train_step``, and the staleness lives in the
optimizer's delay FIFO.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.engine.base import EngineState, PipelineEngine
from repro_torch.models.model import Transformer, param_leaves
from repro_torch.optim.base import Optimizer
from repro_torch.pipeline.simulate import make_sim_train_step


class SimEngine(PipelineEngine):
    name = "sim"

    def __init__(self, model: Transformer, optimizer: Optimizer, grad_clip: float = 1.0):
        self.model = model
        self.optimizer = optimizer
        self.device = next(model.parameters()).device
        self._step_fn = make_sim_train_step(model, optimizer, grad_clip)

    def init_state(self) -> EngineState:
        params = param_leaves(self.model)
        return EngineState(params=params, opt_state=self.optimizer.init(params))

    def step(self, state: EngineState, batch: Dict, t: int) -> Tuple[EngineState, Any, Dict]:
        opt_state, loss, metrics = self._step_fn(state.opt_state, batch, t)
        return EngineState(state.params, opt_state), loss, metrics
