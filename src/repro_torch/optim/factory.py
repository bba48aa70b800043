"""Build an optimizer from an OptimizerConfig, wiring the pipeline partition's
per-leaf delays into the stage-aware refresh schedule and the delay FIFO.
Port of ``repro/optim/factory.py::build_optimizer`` for the ``adam`` and
``basis_rotation`` branches; the other baselines are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.core.basis_rotation import basis_rotation_adam
from repro_torch.core.stage_aware import StageContext
from repro_torch.optim.adam import adam
from repro_torch.optim.base import Optimizer, make_schedule
from repro_torch.pipeline.delay import delayed_optimizer
from repro_torch.pipeline.partition import stage_context_for_tree


def build_optimizer(
    ocfg: OptimizerConfig,
    params: Dict[str, torch.Tensor],
    model_cfg: ModelConfig,
    num_stages: int = 1,
    apply_delay: bool = True,
    use_kernels: bool = False,
    stage_context: Optional[StageContext] = None,
) -> Optimizer:
    """Base optimizer, wrapped in the gradient-staleness FIFO when there is
    more than one stage and ``apply_delay`` holds.

    ``stage_context`` carries the per-leaf delays; by default it comes from
    the per-layer partition of ``params``. The SPMD engine passes
    ``stage_context_for_stacked`` so that stacked ``(K, per, ...)`` leaves
    get per-stage refresh-period tuples, and builds with
    ``apply_delay=False``: it wraps the result in ``stage_delayed_optimizer``
    itself."""
    sched = make_schedule(ocfg.schedule, ocfg.learning_rate, ocfg.total_steps, ocfg.warmup_frac)
    ctx = stage_context if stage_context is not None else stage_context_for_tree(
        params, model_cfg, num_stages)

    name = ocfg.name
    if name in ("adam", "adamw", "pipedream"):
        base = adam(sched, ocfg.beta1, ocfg.beta2, ocfg.eps, ocfg.weight_decay)
    elif name == "basis_rotation":
        if ocfg.stage_aware and num_stages > 1:
            freq = ctx.refresh_freqs(ocfg.rotation_freq, ocfg.stage_aware_reversed)
        else:
            freq = ocfg.rotation_freq
        base = basis_rotation_adam(
            sched,
            ocfg.beta1,
            ocfg.beta2,
            ocfg.eps,
            source=ocfg.rotation_source,
            geometry=ocfg.rotation_geometry,
            freq=freq,
            weight_decay=ocfg.weight_decay,
            use_kernels=use_kernels,
        )
    else:
        raise NotImplementedError(f"optimizer {name!r} is not yet ported")

    if apply_delay and num_stages > 1:
        delays = ctx.delay_specs()
        if not all(isinstance(d, int) for d in delays):
            raise ValueError("the per-leaf FIFO needs scalar delays; stage-stacked layouts "
                             "take stage_delayed_optimizer instead")
        base = delayed_optimizer(base, delays)
    return base
