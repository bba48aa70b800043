"""Build an optimizer from an OptimizerConfig, wiring the pipeline partition's
per-leaf delays into the stage-aware refresh schedule and the delay FIFO.
Port of ``repro/optim/factory.py::build_optimizer`` for the ``adam`` and
``basis_rotation`` branches; the other baselines are not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.core.basis_rotation import basis_rotation_adam
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
) -> Optimizer:
    """Base optimizer, wrapped in the gradient-staleness FIFO when there is
    more than one stage and ``apply_delay`` holds."""
    sched = make_schedule(ocfg.schedule, ocfg.learning_rate, ocfg.total_steps, ocfg.warmup_frac)
    ctx = stage_context_for_tree(params, model_cfg, num_stages)

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
        base = delayed_optimizer(base, ctx.delay_specs())
    return base
