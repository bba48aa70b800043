"""One decoder block: norm -> mixer -> norm -> MLP, where the mixer is
attention, mLSTM or sLSTM and the MLP is dense or absent (xLSTM blocks
integrate their own feed-forward: no ``norm2`` and no ``mlp`` leaves).
Port of ``repro/models/transformer.py`` (``block_train``,
``init_block_cache``, ``block_decode``); the Mamba mixer and MoE MLPs come
with their families.

``stage_apply`` runs a pipeline stage's blocks on weights sliced from
stage-stacked ``(K, per, ...)`` tensors (the reference's ``_stage_apply_fn``
in ``engine/schedules.py``), through this same ``Block`` code: a weightless
template block is called with each layer's weights by
``torch.func.functional_call``. Like the reference's, it applies one block
kind to every layer, so the SPMD path takes homogeneous patterns only.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models.attention import Attention, gqa_decode, init_gqa_cache
from repro_torch.models.layers import MLP, Norm, apply_mlp, apply_norm
from repro_torch.models.xlstm import (
    MLSTM,
    SLSTM,
    init_mlstm_cache,
    init_slstm_cache,
    mlstm_decode,
    slstm_decode,
)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, spec: BlockSpec, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        _check_ported(spec)
        dtype = cfg.params_dtype
        self.cfg, self.spec = cfg, spec
        self.norm1 = Norm(cfg.norm, cfg.d_model, dtype, device)
        if spec.mixer == "attn":
            self.mixer = Attention(cfg.d_model, cfg.attention, dtype, device, generator)
        elif spec.mixer == "mlstm":
            self.mixer = MLSTM(cfg.d_model, cfg.ssm, dtype, device, generator)
        else:
            self.mixer = SLSTM(cfg.d_model, cfg.ssm, dtype, device, generator)
        if spec.mlp != "none":
            self.norm2 = Norm(cfg.norm, cfg.d_model, dtype, device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype, device, generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return block_train(self, x, self.cfg)


def block_train(p: Block, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss); without MoE there is no auxiliary loss."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = p.norm1(x)
    if p.spec.mixer == "attn":
        x = x + p.mixer(h, use_kernels=cfg.use_kernels)
    else:
        x = x + p.mixer(h)
    if p.spec.mlp != "none":
        x = x + p.mlp(p.norm2(x))
    return x, aux


def _check_ported(spec: BlockSpec) -> None:
    if spec.mixer == "mamba":
        raise NotImplementedError("not yet ported: the Mamba mixer (models/mamba.py)")
    if spec.mlp == "moe":
        raise NotImplementedError("not yet ported: the MoE MLP (models/moe.py)")
    if spec.mixer not in ("attn", "mlstm", "slstm") or spec.mlp not in ("dense", "none"):
        raise ValueError(f"unknown block {spec.mixer!r} mixer with {spec.mlp!r} MLP")


def init_block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int, seq_len: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    """A zeroed decode cache: the K/V cache of an attention block, the
    recurrent state of an mLSTM or sLSTM block."""
    _check_ported(spec)
    if spec.mixer == "mlstm":
        return init_mlstm_cache(batch, cfg.d_model, cfg.ssm, device)
    if spec.mixer == "slstm":
        return init_slstm_cache(batch, cfg.d_model, cfg.ssm, dtype, device)
    return init_gqa_cache(batch, seq_len, cfg.attention, dtype, device)


def block_decode(w: Mapping[str, torch.Tensor], x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 pos: int, cfg: ModelConfig,
                 spec: BlockSpec) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One block on one new token. ``w`` maps the block's leaf paths
    (``norm1/scale``, ``mixer/w_q``, ``mlp/w_up``) to its weights. The K/V
    cache is written in place; a recurrent mixer returns a new state."""
    _check_ported(spec)
    sub = {}
    for path, t in w.items():
        head, name = path.split("/", 1)
        sub.setdefault(head, {})[name] = t
    h = apply_norm(sub["norm1"]["scale"], sub["norm1"].get("bias"), x)
    if spec.mixer == "attn":
        h, cache = gqa_decode(sub["mixer"], h, cache, pos, cfg.attention)
    elif spec.mixer == "mlstm":
        h, cache = mlstm_decode(sub["mixer"], h, cache, cfg.ssm)
    else:
        h, cache = slstm_decode(sub["mixer"], h, cache, cfg.ssm)
    x = x + h
    if spec.mlp == "none":
        return x, cache
    h = apply_norm(sub["norm2"]["scale"], sub["norm2"].get("bias"), x)
    return x + apply_mlp(sub["mlp"], h), cache


def check_homogeneous(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` if ``cfg.pattern`` mixes block kinds, which the
    stage-stacked (SPMD) layout cannot hold: the reference's runtime stacks
    whole layer trees (``engine/spmd.py::stack_stage_params``) and applies
    ``cfg.pattern[0]`` to every layer (``engine/schedules.py::_stage_apply_fn``)."""
    kinds = sorted({f"{s.mixer}/{s.mlp}" for s in cfg.pattern})
    if len(kinds) != 1:
        raise ValueError(
            f"a pattern of mixed block kinds ({', '.join(kinds)}) cannot run on the spmd "
            "backend: the reference's pipeline runtime stacks whole layer trees and applies "
            "cfg.pattern[0] to every layer, so it takes homogeneous stacks only; use "
            "--backend sim")


def template_block(cfg: ModelConfig) -> Block:
    """A block without weights (on the meta device), for ``stage_apply``."""
    check_homogeneous(cfg)
    return Block(cfg, cfg.pattern[0], "meta", None)


def stage_apply(template: Block, weights: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Run one stage's blocks in order. ``weights`` maps each block leaf path
    (``mixer/w_q``) to that stage's ``(per, ...)`` slice of the stacked leaf."""
    per = next(iter(weights.values())).shape[0]
    names = {path: path.replace("/", ".") for path in weights}
    for l in range(per):
        x, _ = functional_call(template, {names[p]: w[l] for p, w in weights.items()}, (x,))
    return x
