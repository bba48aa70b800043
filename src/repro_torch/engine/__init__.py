"""Pipeline-training engine: one loop, pluggable backends. Only the
simulation backend (`SimEngine`) is ported so far."""
from repro_torch.engine.base import EngineState, PipelineEngine
from repro_torch.engine.loop import LoopConfig, LoopTimings, run_loop
from repro_torch.engine.sim import SimEngine

__all__ = [
    "EngineState",
    "PipelineEngine",
    "LoopConfig",
    "LoopTimings",
    "run_loop",
    "SimEngine",
]
