"""Pipeline-training engine: one loop, pluggable backends: the simulation
(`SimEngine`) and the physical pipeline (`SpmdEngine`) under a tick
schedule (`engine.schedules`: fill-drain or 1F1B). Port of
``repro/engine/__init__.py``."""
from repro_torch.engine.base import EngineState, PipelineEngine
from repro_torch.engine.loop import LoopConfig, LoopTimings, resume_if_present, run_loop
from repro_torch.engine.schedules import (
    SCHEDULES,
    make_1f1b_grad,
    make_fill_drain_loss,
    make_schedule_grad,
    schedule_activation_bytes,
)
from repro_torch.engine.sim import SimEngine
from repro_torch.engine.spmd import (
    SpmdEngine,
    make_pipeline_grad,
    make_pipeline_loss,
    spmd_delay_specs,
    stack_stage_params,
    unstack_stage_params,
)

__all__ = [
    "EngineState",
    "PipelineEngine",
    "LoopConfig",
    "LoopTimings",
    "resume_if_present",
    "run_loop",
    "SCHEDULES",
    "SimEngine",
    "SpmdEngine",
    "make_1f1b_grad",
    "make_fill_drain_loss",
    "make_pipeline_grad",
    "make_pipeline_loss",
    "make_schedule_grad",
    "schedule_activation_bytes",
    "spmd_delay_specs",
    "stack_stage_params",
    "unstack_stage_params",
]
