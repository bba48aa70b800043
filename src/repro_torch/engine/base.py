"""The `PipelineEngine` abstraction (port of ``repro/engine/base.py``): one
async-pipeline train-step contract that the single loop in `engine.loop`
drives.

    state = engine.init_state()
    state, loss, metrics = engine.step(state, batch, t)

The simulation and SPMD backends are ported; checkpointing comes later.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch


@dataclass
class EngineState:
    params: Any
    opt_state: Any


class PipelineEngine(abc.ABC):
    """One asynchronous pipeline-parallel training runtime."""

    name: str = "engine"
    device: torch.device

    @abc.abstractmethod
    def init_state(self) -> EngineState:
        """Build the initial state."""

    @abc.abstractmethod
    def step(self, state: EngineState, batch: Dict, t: int) -> Tuple[EngineState, Any, Dict]:
        """One optimizer step. Returns (new_state, loss, metrics)."""

    def synchronize(self) -> None:
        """Wait until the device has finished the work queued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
