"""Pipeline-training engine: one loop, pluggable backends: the simulation
(`SimEngine`) and the physical pipeline (`SpmdEngine`)."""
from repro_torch.engine.base import EngineState, PipelineEngine
from repro_torch.engine.loop import LoopConfig, LoopTimings, resume_if_present, run_loop
from repro_torch.engine.sim import SimEngine
from repro_torch.engine.spmd import SpmdEngine

__all__ = [
    "EngineState",
    "PipelineEngine",
    "LoopConfig",
    "LoopTimings",
    "resume_if_present",
    "run_loop",
    "SimEngine",
    "SpmdEngine",
]
