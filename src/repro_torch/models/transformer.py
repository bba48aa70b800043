"""One decoder block: norm -> attention -> norm -> dense MLP.
Port of ``repro/models/transformer.py::block_train`` for the attention mixer
and the dense MLP; the recurrent mixers and MoE come with their families.

``stage_apply`` runs a pipeline stage's blocks on weights sliced from
stage-stacked ``(K, per, ...)`` tensors (the reference's ``_stage_apply_fn``
in ``engine/schedules.py``), through this same ``Block`` code: a weightless
template block is called with each layer's weights by
``torch.func.functional_call``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Norm


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, spec: BlockSpec, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        if spec.mixer != "attn" or spec.mlp != "dense":
            raise NotImplementedError(
                f"not yet ported: {spec.mixer} mixer with {spec.mlp} MLP"
            )
        dtype = cfg.params_dtype
        self.cfg = cfg
        self.norm1 = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.mixer = Attention(cfg.d_model, cfg.attention, dtype, device, generator)
        self.norm2 = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype, device, generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return block_train(self, x, self.cfg)


def block_train(p: Block, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss); a dense block has no auxiliary loss."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = x + p.mixer(p.norm1(x), use_kernels=cfg.use_kernels)
    x = x + p.mlp(p.norm2(x))
    return x, aux


def template_block(cfg: ModelConfig) -> Block:
    """A block without weights (on the meta device), for ``stage_apply``."""
    if len(set(cfg.pattern)) != 1:
        raise NotImplementedError("not yet ported: stage stacks of mixed block kinds")
    return Block(cfg, cfg.pattern[0], "meta", None)


def stage_apply(template: Block, weights: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Run one stage's blocks in order. ``weights`` maps each block leaf path
    (``mixer/w_q``) to that stage's ``(per, ...)`` slice of the stacked leaf."""
    per = next(iter(weights.values())).shape[0]
    names = {path: path.replace("/", ".") for path in weights}
    for l in range(per):
        x, _ = functional_call(template, {names[p]: w[l] for p, w in weights.items()}, (x,))
    return x
