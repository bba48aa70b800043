"""Whole-model API: init, training forward and loss.
Port of ``repro/models/model.py`` for per-layer (``scan_layers=False``)
dense attention models.

The module tree mirrors the reference's parameter tree, so that
``named_parameters`` names map onto its leaf paths (``blocks/3/mixer/w_q``,
``embed/embedding``, ``lm_head``, ``pos_emb``, ``final_norm/scale``).
Weights are drawn from an explicit CPU ``torch.Generator`` and then moved to
the device, so a seed gives the same weights on every device; they do not
reproduce ``jax.random`` (the tests carry weights across with
``repro_torch.checkpoint.convert``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layout import path_str, tree_order_key
from repro_torch.models.layers import Norm, dense_init, embed_init, param
from repro_torch.models.transformer import Block

Tensor = torch.Tensor

IGNORE_INDEX = -100


class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, dtype, device, generator):
        super().__init__()
        self.embedding = param(embed_init((vocab, d_model), generator), dtype, device)


class Transformer(nn.Module):
    """Decoder-only transformer. ``seed=None`` leaves the weights
    uninitialised, for callers that load them."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str = "cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        if cfg.scan_layers:
            raise NotImplementedError(
                "not yet ported: stacked (scan_layers=True) parameters; "
                "use cfg.replace(scan_layers=False)"
            )
        if cfg.loss_chunk:
            raise NotImplementedError("not yet ported: chunked cross-entropy")
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        dtype = cfg.params_dtype
        self.cfg = cfg
        V, d = cfg.vocab_size, cfg.d_model
        self.embed = Embedding(V, d, dtype, device, gen)
        if not cfg.tie_embeddings:
            self.lm_head = param(dense_init((d, V), gen), dtype, device)
        if cfg.learnable_pos_emb:
            self.pos_emb = param(embed_init((cfg.max_seq_len, d), gen), dtype, device)
        self.blocks = nn.ModuleList(
            Block(cfg, cfg.pattern[l % len(cfg.pattern)], device, gen)
            for l in range(cfg.num_layers)
        )
        self.final_norm = Norm(cfg.norm, d, dtype, device)

    def forward(self, tokens: Tensor) -> Tuple[Tensor, Tensor]:
        return forward_train(self, tokens)


def init_model(cfg: ModelConfig, seed: int = 0, device: torch.device | str = "cuda") -> Transformer:
    return Transformer(cfg, device=device, seed=seed)


def param_leaves(model: nn.Module) -> Dict[str, nn.Parameter]:
    """``{path: parameter}`` in the reference's ``tree_flatten`` leaf order."""
    named = {path_str(n): p for n, p in model.named_parameters()}
    return {k: named[k] for k in sorted(named, key=tree_order_key)}


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _logits(model: Transformer, x: Tensor) -> Tensor:
    cfg = model.cfg
    dt = torch.float32 if cfg.logits_fp32 else cfg.compute_dtype
    head = model.embed.embedding.T if cfg.tie_embeddings else model.lm_head
    return x.to(dt) @ head.to(dt)


def forward_train(model: Transformer, tokens: Tensor) -> Tuple[Tensor, Tensor]:
    """Returns (logits, aux_loss). tokens: (B, S) int64."""
    cfg = model.cfg
    x = model.embed.embedding[tokens].to(cfg.compute_dtype)
    if cfg.learnable_pos_emb:
        x = x + model.pos_emb[: x.shape[1]].to(x.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in model.blocks:
        x, a = block(x)
        aux = aux + a
    x = model.final_norm(x)
    return _logits(model, x), aux


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean CE over non-ignored positions. logits: (..., V), labels: (...)."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)


def loss_fn(model: Transformer, batch: Dict[str, Tensor]) -> Tuple[Tensor, Dict[str, Tensor]]:
    logits, aux = forward_train(model, batch["tokens"])
    ce = cross_entropy(logits, batch["labels"])
    return ce + aux, {"ce": ce, "aux": aux}
