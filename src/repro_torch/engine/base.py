"""The `PipelineEngine` abstraction (port of ``repro/engine/base.py``): one
async-pipeline train-step contract that the single loop in `engine.loop`
drives.

    state = engine.init_state()
    state, loss, metrics = engine.step(state, batch, t)

`EngineState` is a plain container: `params` and `opt_state` are
backend-specific (the SPMD engine keeps the stage-stacked layout),
`history` is the sim backend's no-stash snapshot window, and `data_fifo`
the SPMD engine's deferred data reductions under an asynchronous data
axis. `checkpoint_tree` and `load_state` convert to and from the
reference's ``(params, opt_state[, data_fifo])`` tree of numpy arrays,
which the checkpointer stores.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclass
class EngineState:
    params: Any
    opt_state: Any
    history: List[Any] = field(default_factory=list)
    # asynchronous data axis (SpmdEngine ``data_async``): the last D deferred
    # cross-replica gradient reductions, oldest first; None when the data
    # axis is synchronous
    data_fifo: Optional[List[Any]] = None


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

    # -- checkpointing -----------------------------------------------------

    @abc.abstractmethod
    def checkpoint_tree(self, state: EngineState) -> Any:
        """The reference's ``(params, opt_state)`` tree, as numpy copies on
        the host that later steps cannot change: the steps update parameters
        and optimizer state in place."""

    @abc.abstractmethod
    def load_state(self, tree: Any) -> EngineState:
        """Rebuild an `EngineState` from a ``checkpoint_tree``. The no-stash
        history window is not checkpointed, as in the reference: after a
        resume the first max-delay steps fall back to the freshest snapshot
        there is."""

    def checkpoint_job(
        self, path: str, state: EngineState, step: int = 0, meta: Optional[Dict] = None,
    ) -> Callable[[], None]:
        """Snapshot ``state`` to the host now; return the deferred write.

        The snapshot runs on the loop thread before the next step changes
        the state in place; the returned closure does only host file I/O
        and may run on a background writer thread (``engine.loop`` submits
        it there under ``LoopConfig.async_io``)."""
        host_tree = self.checkpoint_tree(state)

        def write() -> None:
            from repro_torch.checkpoint.ckpt import save_checkpoint

            save_checkpoint(path, host_tree, step=step, meta=meta)

        return write

    def save_checkpoint(
        self, path: str, state: EngineState, step: int = 0, meta: Optional[Dict] = None,
    ) -> None:
        """Write ``state`` under ``path`` now; the engine picks the format."""
        self.checkpoint_job(path, state, step=step, meta=meta)()
