"""Rotation layout: decide, per parameter leaf, whether basis rotation applies
and on which side(s). Port of ``repro/core/layout.py``.

Parameters travel through the optimizer stack as an ordered ``{path: tensor}``
dict whose keys are the reference's ``/``-joined leaf paths, in the order
``jax.tree_util.tree_flatten`` gives them: dict keys sorted as strings,
sequence items by index. Every per-leaf list (optimizer state, delays,
refresh periods) is ordered like that dict, so this order is part of the
contract with the reference: ``nn.Module.named_parameters`` yields
registration order, and a plain string sort puts ``blocks/10`` before
``blocks/2``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

EXCLUDE_SUBSTRINGS = (
    "embed",
    "lm_head",
    "pos_emb",
    "norm",
    "bias",
    "b_q",
    "b_k",
    "b_v",
    "b_i",
    "b_f",
    "scale",
    "A_log",
    "dt_bias",
    "conv_b",
    "frontend_proj",
)


@dataclass(frozen=True)
class LeafPlan:
    path: str
    shape: Tuple[int, ...]
    rotate: bool
    left: bool  # rotate rows (U)
    right: bool  # rotate cols (V)


def path_str(name: str) -> str:
    """``named_parameters`` name -> reference leaf path (``a.0.b`` -> ``a/0/b``)."""
    return name.replace(".", "/")


def tree_order_key(path: str):
    """Sort key that reproduces ``jax.tree_util.tree_flatten`` order: sequence
    indices compare as integers, dict keys as strings."""
    return tuple(
        (0, int(p), "") if p.isdigit() else (1, 0, p) for p in path.split("/")
    )


def plan_leaf(path: str, shape: Tuple[int, ...], geometry: str, min_dim: int = 8) -> LeafPlan:
    rotatable = (
        len(shape) >= 2
        and min(shape[-2], shape[-1]) >= min_dim
        and not any(s in path for s in EXCLUDE_SUBSTRINGS)
    )
    if not rotatable:
        return LeafPlan(path, shape, False, False, False)
    if geometry == "bilateral":
        return LeafPlan(path, shape, True, True, True)
    # unilateral: rotate the smaller dimension's side (cheaper, Appendix H)
    m, n = shape[-2], shape[-1]
    return LeafPlan(path, shape, True, m <= n, m > n)


def build_layout(
    params: Dict[str, torch.Tensor], geometry: str, min_dim: int = 8
) -> List[LeafPlan]:
    return [plan_leaf(k, tuple(x.shape), geometry, min_dim) for k, x in params.items()]
