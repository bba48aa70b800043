"""Carry parameters between the reference's tree and the port's model.

The reference keeps parameters as a nested tree of dicts and tuples; after
``jax.tree.map(np.asarray, params)`` its leaves are numpy arrays.
``params_from_numpy`` builds the port's model from such a tree and
``params_to_numpy`` is its exact inverse, leaf for leaf, with the same
shapes (projections stay (in, out)) and the same ``/``-joined leaf paths.
``stacked_from_numpy`` and ``stacked_to_numpy`` do the same for the SPMD
engine's stage-stacked ``(stacked, shared)`` pair (the reference's
``stack_stage_params`` output).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layout import tree_order_key
from repro_torch.models.model import Transformer, param_leaves


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts / tuples / lists -> ``{path: leaf}``."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else k))
    return out


def unflatten_tree(flat: Dict[str, Any]) -> Any:
    """``{path: leaf}`` -> nested dicts, with all-index levels as tuples."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def seal(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return tuple(seal(node[str(i)]) for i in range(len(node)))
        return {k: seal(v) for k, v in node.items()}

    return seal(root)


def params_from_numpy(tree: Any, cfg: ModelConfig,
                      device: torch.device | str = "cuda") -> Transformer:
    """The port's model holding exactly the reference tree's weights."""
    model = Transformer(cfg, device=device, seed=None)
    flat = flatten_tree(tree)
    leaves = param_leaves(model)
    if set(flat) != set(leaves):
        raise ValueError(
            f"parameter trees differ: only in reference {sorted(set(flat) - set(leaves))}, "
            f"only in port {sorted(set(leaves) - set(flat))}"
        )
    with torch.no_grad():
        for path, p in leaves.items():
            arr = np.asarray(flat[path])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{path}: shape {arr.shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr)))
    return model


def params_to_numpy(model: Transformer) -> Any:
    """The model's weights as the reference's nested tree of numpy arrays."""
    return unflatten_tree(
        {k: p.detach().cpu().numpy().copy() for k, p in param_leaves(model).items()}
    )


def _ordered(flat: Dict[str, Any]) -> Dict[str, Any]:
    return {k: flat[k] for k in sorted(flat, key=tree_order_key)}


def stacked_from_numpy(tree: Tuple[Any, Any], device: torch.device | str = "cuda"
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The reference's ``(stacked, shared)`` numpy tree as the port's pair of
    ``{path: tensor}`` dicts, each in leaf order, values exactly equal."""
    return tuple(
        {k: torch.from_numpy(np.array(v)).to(device) for k, v in _ordered(flatten_tree(t)).items()}
        for t in tree)


def stacked_to_numpy(stacked: Dict[str, torch.Tensor], shared: Dict[str, torch.Tensor]
                     ) -> Tuple[Any, Any]:
    """The inverse of ``stacked_from_numpy``."""
    return tuple(unflatten_tree({k: v.detach().cpu().numpy().copy() for k, v in d.items()})
                 for d in (stacked, shared))
