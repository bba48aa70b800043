"""Mixture-of-Experts MLP with capacity-based dispatch. Port of
``repro/models/moe.py`` (``init_moe``, ``moe_capacity``, ``_top_k_gates``,
``_group_size``, ``apply_moe``).

Tokens are routed within GShard groups: each group of ``g`` tokens sends
each token to its top-k experts, and each expert takes at most
``moe_capacity(g)`` tokens of a group, in token order; a token past its
expert's capacity gets a zero row from that expert. Dispatch and combine
are one-hot einsums, and the experts run as one batched product over the
stacked ``(E, d, d_ff)`` expert weights, as in the reference; no kernel
computes them. The router and its logits are float32; dispatch and
combine are in the compute dtype. Routed experts always use gated SiLU;
the optional shared (always-on) experts are an ``MLP`` of the config's
activation. The load-balance auxiliary loss is Switch/GShard's
``aux_loss_coef * E * mean over groups of sum_e f_e p_e``.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.core.layout import path_str
from repro_torch.models.layers import MLP, apply_mlp, dense_init, param

Tensor = torch.Tensor


class MoE(nn.Module):
    """Leaves ``router`` (d, E), ``w_gate_e`` and ``w_up_e`` (E, d, d_ff_e),
    ``w_down_e`` (E, d_ff_e, d) and, with shared experts, ``shared/*``."""

    def __init__(self, d_model: int, d_ff: int, cfg: MoEConfig, act: str, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.cfg = cfg
        d_ff_e = cfg.d_ff_expert or d_ff
        E = cfg.num_experts
        scale = 1.0 / math.sqrt(d_model)
        self.router = param(dense_init((d_model, E), generator), torch.float32, device)
        self.w_gate_e = param(dense_init((E, d_model, d_ff_e), generator, scale), dtype, device)
        self.w_up_e = param(dense_init((E, d_model, d_ff_e), generator, scale), dtype, device)
        self.w_down_e = param(dense_init((E, d_ff_e, d_model), generator,
                                         1.0 / math.sqrt(d_ff_e)), dtype, device)
        if cfg.num_shared > 0:
            self.shared = MLP(d_model, d_ff_e * cfg.num_shared, act, dtype, device, generator)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        return apply_moe({path_str(n): p for n, p in self.named_parameters()}, x, self.cfg)


def moe_capacity(num_tokens: int, cfg: MoEConfig) -> int:
    """Tokens one expert takes from a group of ``num_tokens``: at least 4."""
    cap = int(math.ceil(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts))
    return max(cap, 4)


def _top_k_gates(logits: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """(gates (..., E) zero off each token's top k and renormalised over
    them, mask (..., E) in {0, 1}), in float32."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    top_idx = torch.topk(probs, k, dim=-1).indices
    mask = F.one_hot(top_idx, E).sum(dim=-2).float()
    gates = probs * mask
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, mask


def _group_size(T: int, target: int) -> int:
    """Largest divisor of T that is <= target (the GShard group size)."""
    g = max(1, min(T, target))
    while T % g:
        g -= 1
    return g


def apply_moe(w: Mapping[str, Tensor], x: Tensor, cfg: MoEConfig) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (output (B, S, d), float32 aux loss). ``w`` maps the
    MoE's leaf names (``router``, ``w_gate_e``, ``shared/w_up``) to its
    weights."""
    B, S, D = x.shape
    T, E = B * S, cfg.num_experts
    g = _group_size(T, cfg.group_size)
    G = T // g
    xg = x.reshape(G, g, D)

    logits = xg.float() @ w["router"].float()  # (G, g, E)
    gates, mask = _top_k_gates(logits, cfg.top_k)

    probs = torch.softmax(logits, dim=-1)
    f = mask.mean(dim=1)  # (G, E): fraction of each group's tokens routed to e
    p = probs.mean(dim=1)
    aux = cfg.aux_loss_coef * E * torch.mean(torch.sum(f * p, dim=-1))

    C = moe_capacity(g, cfg)
    # each token's slot in its experts' buffers, in token order (per group);
    # a token past an expert's capacity takes slot -1, whose one-hot row is
    # zero (F.one_hot would raise on it)
    pos = torch.cumsum(mask, dim=1) * mask - 1.0  # (G, g, E)
    fits = (pos < C) & (mask > 0)
    slot = torch.where(fits, pos, torch.full_like(pos, -1.0)).long()
    dispatch = (slot[..., None] == torch.arange(C, device=x.device)).to(x.dtype)  # (G,g,E,C)
    combine = gates.to(x.dtype)[..., None] * dispatch

    expert_in = torch.einsum("gtec,gtd->gecd", dispatch, xg)
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, w["w_gate_e"]))
    h = h * torch.einsum("gecd,edf->gecf", expert_in, w["w_up_e"])
    expert_out = torch.einsum("gecf,efd->gecd", h, w["w_down_e"])
    yg = torch.einsum("gtec,gecd->gtd", combine, expert_out)

    shared = {k.split("/", 1)[1]: v for k, v in w.items() if k.startswith("shared/")}
    if shared:
        yg = yg + apply_mlp(shared, xg)
    return yg.reshape(B, S, D), aux
