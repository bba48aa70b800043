"""Compatibility shim, as ``repro/pipeline/spmd.py`` is: the pipeline
runtime lives in the engine (``repro_torch.engine.spmd`` and
``repro_torch.engine.schedules``), and import sites keep working through
this module."""
from repro_torch.engine.schedules import (  # noqa: F401
    SCHEDULES,
    make_1f1b_grad,
    make_schedule_grad,
    schedule_activation_bytes,
)
from repro_torch.engine.spmd import (  # noqa: F401
    SpmdEngine,
    make_pipeline_grad,
    make_pipeline_loss,
    spmd_delay_specs,
    stack_stage_params,
    unstack_stage_params,
)

__all__ = [
    "SCHEDULES",
    "SpmdEngine",
    "make_1f1b_grad",
    "make_pipeline_grad",
    "make_pipeline_loss",
    "make_schedule_grad",
    "schedule_activation_bytes",
    "spmd_delay_specs",
    "stack_stage_params",
    "unstack_stage_params",
]
