"""Layer -> pipeline-stage partition and per-parameter delay maps.
Port of ``repro/pipeline/partition.py``: the per-layer (sim) layout and the
SPMD stage-stacked layout.

PipeDream semantics: with K stages k = 0..K-1, a parameter on stage k incurs
gradient delay tau_k = K-1-k. The embedding and position embedding live
with stage 0 (tau = K-1), the final norm and LM head with the last stage
(tau = 0).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.stage_aware import StageContext

FIRST_STAGE_SHARED = ("embed", "pos_emb", "frontend_proj")


def layer_to_stage(num_layers: int, num_stages: int) -> List[int]:
    """Contiguous equal split of layers over stages."""
    if num_stages < 1:
        raise ValueError(f"num_stages must be >= 1, got {num_stages}")
    per = max(1, num_layers // num_stages)
    return [min(l // per, num_stages - 1) for l in range(num_layers)]


def stage_of_path(path: str, cfg: ModelConfig, num_stages: int) -> int:
    """Stage index for a per-layer parameter path."""
    l2s = layer_to_stage(cfg.num_layers, num_stages)
    parts = path.split("/")
    if parts[0] == "blocks":
        return l2s[int(parts[1])]
    if parts[0] in FIRST_STAGE_SHARED:
        return 0
    return num_stages - 1  # final_norm / lm_head


def leaf_stages(params: Dict[str, torch.Tensor], cfg: ModelConfig, num_stages: int) -> List[int]:
    return [stage_of_path(k, cfg, num_stages) for k in params]


def leaf_delays(params: Dict[str, torch.Tensor], cfg: ModelConfig, num_stages: int) -> List[int]:
    """Per-leaf gradient delay tau = K-1-stage, in leaf order."""
    return [num_stages - 1 - s for s in leaf_stages(params, cfg, num_stages)]


def delay_tree(params: Dict[str, torch.Tensor], cfg: ModelConfig, num_stages: int) -> Dict[str, int]:
    return dict(zip(params, leaf_delays(params, cfg, num_stages)))


def stage_context_for_tree(
    params: Dict[str, torch.Tensor], cfg: ModelConfig, num_stages: int, data_delay: int = 0
) -> StageContext:
    """Per-layer (sim) layout: every leaf lives wholly on one stage.
    ``data_delay`` is the uniform extra staleness of an asynchronous data
    axis: delay-aware consumers see tau + data_delay."""
    return StageContext(
        num_stages=num_stages, delays=tuple(leaf_delays(params, cfg, num_stages)),
        data_delay=data_delay,
    )


def stage_context_for_stacked(
    stacked: Dict[str, torch.Tensor], shared: Dict[str, torch.Tensor], num_stages: int,
    data_delay: int = 0,
) -> StageContext:
    """SPMD stage-stacked layout, for the leaves of ``(stacked, shared)`` in
    that order (each dict in the reference's leaf order).

    Stacked block leaves have shape ``(K, per, ...)``: per-stage delays
    ``(K-1, ..., 0)`` over the leading axis, each slot standing for ``per``
    per-layer leaves. Shared leaves get the delay of the stage that owns
    them: the embedding K-1, the final norm and the head 0. ``data_delay``
    as in ``stage_context_for_tree``."""
    K = num_stages
    stage_delays = tuple(K - 1 - k for k in range(K))
    shapes = [tuple(x.shape) for x in stacked.values()]
    pers = {s[1] for s in shapes if len(s) > 1}
    if len(pers) > 1 or any(s[0] != K for s in shapes):
        raise ValueError(f"stacked leaves must share a (K={K}, per, ...) layout, got {shapes}")
    per = pers.pop() if pers else 1
    delays: List = [stage_delays] * len(stacked)
    repeats: List[int] = [per] * len(stacked)
    for path in shared:
        delays.append(K - 1 if path.split("/")[0] in FIRST_STAGE_SHARED else 0)
        repeats.append(1)
    return StageContext(num_stages=K, delays=tuple(delays), repeats=tuple(repeats),
                        data_delay=data_delay)
