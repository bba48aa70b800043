"""Build an optimizer (the paper's method and every baseline) from an
OptimizerConfig, wiring the pipeline partition's per-leaf delays into the
stage-aware refresh schedule, the delay-aware baselines and the delay FIFO.
Port of ``repro/optim/factory.py::build_optimizer``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.core.basis_rotation import basis_rotation_adam
from repro_torch.core.stage_aware import StageContext
from repro_torch.optim.adam import adam, adasgd, nesterov_adam
from repro_torch.optim.base import Optimizer, make_schedule
from repro_torch.optim.delay_aware import delay_compensation, nesterov_pp, pipedream_lr
from repro_torch.optim.muon import muon
from repro_torch.optim.scion import scion
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
    data_delay: int = 0,
) -> Optimizer:
    """Base optimizer, wrapped in the gradient-staleness FIFO when there is
    more than one stage or a data delay and ``apply_delay`` holds; for
    ``delay_compensation`` the FIFO also queues the stale weights it reads.

    ``stage_context`` carries the per-leaf delays; by default it comes from
    the per-layer partition of ``params``. The SPMD engine passes
    ``stage_context_for_stacked`` so that stacked ``(K, per, ...)`` leaves
    get per-stage delays and refresh periods, and builds with
    ``apply_delay=False``: it wraps the result in ``stage_delayed_optimizer``
    itself.

    ``data_delay=D`` is the uniform extra staleness of an asynchronous data
    axis: delay-aware bases see tau + D through the context, and the FIFO
    deepens every leaf's queue by D, the sim backend's model of a D-step
    deferred reduction (one replica's reduction is the identity, so delaying
    its gradient by D is the deferred-reduction semantics)."""
    sched = make_schedule(ocfg.schedule, ocfg.learning_rate, ocfg.total_steps, ocfg.warmup_frac)
    ctx = stage_context if stage_context is not None else stage_context_for_tree(
        params, model_cfg, num_stages, data_delay=data_delay)

    name = ocfg.name
    if name in ("adam", "adamw", "pipedream"):
        base = adam(sched, ocfg.beta1, ocfg.beta2, ocfg.eps, ocfg.weight_decay)
    elif name == "adasgd":
        base = adasgd(sched, ocfg.beta1, ocfg.beta2, ocfg.eps)
    elif name == "nesterov":
        base = nesterov_adam(sched, ocfg.nesterov_beta, ocfg.beta2, ocfg.eps)
    elif name == "nesterov_pp":
        # look-ahead horizon per leaf = its total delay
        base = nesterov_pp(sched, ctx.delay_scales(params), ocfg.nesterov_beta, ocfg.beta2,
                           ocfg.eps)
    elif name == "pipedream_lr":
        base = pipedream_lr(sched, ctx.delay_scales(params), ocfg.beta1, ocfg.beta2, ocfg.eps)
    elif name == "delay_compensation":
        base = delay_compensation(sched, ocfg.dc_lambda, ocfg.beta1, ocfg.beta2, ocfg.eps)
    elif name == "muon":
        base = muon(sched, beta2=ocfg.beta2, eps=ocfg.eps)
    elif name == "scion":
        base = scion(sched)
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
        raise ValueError(f"unknown optimizer {name}")

    if apply_delay and (num_stages > 1 or data_delay > 0):
        delays = ctx.delay_specs()
        if not all(isinstance(d, int) for d in delays):
            raise ValueError("the per-leaf FIFO needs scalar delays; stage-stacked layouts "
                             "take stage_delayed_optimizer instead")
        # one FIFO imposes the total delay tau + D per leaf, on the gradients
        # and on delay compensation's weight snapshots alike
        base = delayed_optimizer(base, [d + data_delay for d in delays],
                                 store_params=(name == "delay_compensation"))
    return base
