"""One decoder block: norm -> attention -> norm -> dense MLP.
Port of ``repro/models/transformer.py`` (``block_train``,
``init_block_cache``, ``block_decode``) for the attention mixer and the
dense MLP; the recurrent mixers and MoE come with their families.

``stage_apply`` runs a pipeline stage's blocks on weights sliced from
stage-stacked ``(K, per, ...)`` tensors (the reference's ``_stage_apply_fn``
in ``engine/schedules.py``), through this same ``Block`` code: a weightless
template block is called with each layer's weights by
``torch.func.functional_call``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models.attention import Attention, gqa_decode, init_gqa_cache
from repro_torch.models.layers import MLP, Norm, apply_mlp, apply_norm


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, spec: BlockSpec, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        _check_ported(spec)
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


def _check_ported(spec: BlockSpec) -> None:
    if spec.mixer != "attn" or spec.mlp != "dense":
        raise NotImplementedError(f"not yet ported: {spec.mixer} mixer with {spec.mlp} MLP")


def init_block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int, seq_len: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    _check_ported(spec)
    return init_gqa_cache(batch, seq_len, cfg.attention, dtype, device)


def block_decode(w: Mapping[str, torch.Tensor], x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 pos: int, cfg: ModelConfig,
                 spec: BlockSpec) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One block on one new token. ``w`` maps the block's leaf paths
    (``norm1/scale``, ``mixer/w_q``, ``mlp/w_up``) to its weights."""
    _check_ported(spec)
    sub = {}
    for path, t in w.items():
        head, name = path.split("/", 1)
        sub.setdefault(head, {})[name] = t
    h = apply_norm(sub["norm1"]["scale"], sub["norm1"].get("bias"), x)
    h, cache = gqa_decode(sub["mixer"], h, cache, pos, cfg.attention)
    x = x + h
    h = apply_norm(sub["norm2"]["scale"], sub["norm2"].get("bias"), x)
    return x + apply_mlp(sub["mlp"], h), cache


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
