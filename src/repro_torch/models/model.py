"""Whole-model API: init, training forward and loss.
Port of ``repro/models/model.py`` for per-layer (``scan_layers=False``)
dense attention models. ``embed`` and ``head_logits`` (the reference's
``_embed`` and ``_logits`` with the final norm) take the shared weights as a
``{path: tensor}`` dict, so that the SPMD schedules run the same code on
their own copies of those weights.

The module tree mirrors the reference's parameter tree, so that
``named_parameters`` names map onto its leaf paths (``blocks/3/mixer/w_q``,
``embed/embedding``, ``lm_head``, ``pos_emb``, ``final_norm/scale``).
Parameters are float32 masters; under the ``bf16`` precision policy the
SPMD schedules run on compute-dtype copies made by ``cast_params``, as the
reference casts its masters at use.
Weights are drawn from an explicit CPU ``torch.Generator`` and then moved to
the device, so a seed gives the same weights on every device; they do not
reproduce ``jax.random`` (the tests carry weights across with
``repro_torch.checkpoint.convert``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layout import path_str, tree_order_key
from repro_torch.models.layers import Norm, apply_norm, dense_init, embed_init, param
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


def cast_params(params: Mapping[str, Tensor], dtype: torch.dtype) -> Dict[str, Tensor]:
    """Mixed precision: float32 master weights -> compute-dtype copies at use.
    Floating leaves go to ``dtype``, other leaves pass through; a leaf already
    in ``dtype`` is returned as it is. The autograd of ``.to()`` hands each
    master a float32 gradient."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}


def shared_leaves(model: Transformer) -> Dict[str, Tensor]:
    """The weights outside the blocks, ``{path: parameter}`` in leaf order."""
    return {k: p for k, p in param_leaves(model).items() if not k.startswith("blocks/")}


def embed(shared: Mapping[str, Tensor], cfg: ModelConfig, tokens: Tensor) -> Tensor:
    """Token (and learnable position) embedding of (..., S) tokens."""
    x = shared["embed/embedding"][tokens].to(cfg.compute_dtype)
    if cfg.learnable_pos_emb:
        x = x + shared["pos_emb"][: tokens.shape[-1]].to(x.dtype)
    return x


def head_logits(shared: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor) -> Tensor:
    """Final norm, then the LM head (float32 logits unless told otherwise)."""
    x = apply_norm(shared["final_norm/scale"], shared.get("final_norm/bias"), x)
    dt = torch.float32 if cfg.logits_fp32 else cfg.compute_dtype
    head = shared["embed/embedding"].T if cfg.tie_embeddings else shared["lm_head"]
    return x.to(dt) @ head.to(dt)


def forward_train(model: Transformer, tokens: Tensor) -> Tuple[Tensor, Tensor]:
    """Returns (logits, aux_loss). tokens: (B, S) int64."""
    shared = shared_leaves(model)
    x = embed(shared, model.cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in model.blocks:
        x, a = block(x)
        aux = aux + a
    return head_logits(shared, model.cfg, x), aux


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
