"""One decoder block: norm -> attention -> norm -> dense MLP.
Port of ``repro/models/transformer.py::block_train`` for the attention mixer
and the dense MLP; the recurrent mixers and MoE come with their families.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

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
