"""Carry parameters and optimizer state between the reference's tree and the port.

The reference keeps parameters as a nested tree of dicts and tuples; after
``jax.tree.map(np.asarray, params)`` its leaves are numpy arrays.
``params_from_numpy`` builds the port's model from such a tree and
``params_to_numpy`` is its exact inverse, leaf for leaf, with the same
shapes (projections stay (in, out)) and the same ``/``-joined leaf paths.
``stacked_from_numpy`` and ``stacked_to_numpy`` do the same for the SPMD
engine's stage-stacked ``(stacked, shared)`` pair (the reference's
``stack_stage_params`` output). Every leaf crosses by its path, whatever
its rank: the MoE's router and ``(E, d, d_ff)`` expert stacks (``(K, per,
E, d, d_ff)`` stage-stacked), a ``(K, V, d)`` codebook embedding,
``frontend_proj``, the Mamba mixer's ``in_proj``, ``conv_w``, ``conv_b``,
``x_proj``, ``dt_proj``, ``out_proj`` and float32 ``A_log`` (d_inner,
d_state), ``dt_bias`` and ``D``, MLA's ``kv_a``, ``kv_a_norm``, ``kv_b``,
``w_o`` and ``q_a``, ``q_a_norm``, ``q_b`` (or ``w_q``), and the optimizer
state over them.

``opt_state_to_numpy`` and ``opt_state_from_numpy`` carry optimizer state:
moments kept per leaf (adam, nesterov, nesterov_pp, pipedream_lr,
delay_compensation and muon: ``{"m": tree, "v": tree}``; scion: ``{"m":
tree}``) or as one scalar (adasgd's ``v``), ``basis_rotation``'s per-leaf
dicts (``m``, ``v``, ``U``, ``V``, ``L``, ``R``) and the delay wrappers'
gradient queues ``grad_q`` and, for delay compensation, weight queues
``param_q``. There the layouts differ: the port keeps each FIFO as a ring
buffer advanced by one shared ``head``, the reference in logical order with
row 0 the oldest and no ``head``. Logical row r is ring slot ``(head + r) %
d``, for the per-leaf queues and the stage queues alike; a restored ring
starts at ``head = 0``.

A model of stacked layers (``scan_layers=True``) crosses the same way:
its leaves are the reference's stacked tree's (``blocks/<position>/...``
with a leading axis of ``num_superblocks``). ``stack_layers`` and
``unstack_layers`` move ``{path: leaf}`` dicts of numpy arrays or tensors
between that layout and the per-layer one (layer l is superblock
``l // P``'s slot of pattern position ``l % P``), the counterpart of the
``jnp.stack`` regrouping of the reference's tests.

``fifo_to_numpy`` and ``fifo_from_numpy`` carry the SPMD engine's
deferred data reductions (an asynchronous data axis): a tuple of
``(stacked, shared)`` gradient trees, oldest first, the third element of the
reference's checkpoint tree.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

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


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that nothing done to ``t`` afterwards changes
    (``.cpu()`` of a CPU tensor would return the tensor itself)."""
    return t.detach().to("cpu", copy=True).numpy()


def _fill(dst: torch.Tensor, src: Any, what: str) -> None:
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {arr.shape} != {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(arr)))


@torch.no_grad()
def copy_params_from_numpy(params: Dict[str, torch.Tensor], tree: Any) -> None:
    """Copy the reference parameter tree's values into ``params`` in place."""
    flat = flatten_tree(tree)
    if set(flat) != set(params):
        raise ValueError(
            f"parameter trees differ: only in reference {sorted(set(flat) - set(params))}, "
            f"only in port {sorted(set(params) - set(flat))}"
        )
    for k, p in params.items():
        _fill(p, flat[k], k)


def params_from_numpy(tree: Any, cfg: ModelConfig,
                      device: torch.device | str = "cuda") -> Transformer:
    """The port's model holding exactly the reference tree's weights."""
    model = Transformer(cfg, device=device, seed=None)
    copy_params_from_numpy(param_leaves(model), tree)
    return model


def params_to_numpy(model: Transformer) -> Any:
    """The model's weights as the reference's nested tree of numpy arrays."""
    return unflatten_tree({k: host_copy(p) for k, p in param_leaves(model).items()})


def _ordered(flat: Dict[str, Any]) -> Dict[str, Any]:
    return {k: flat[k] for k in sorted(flat, key=tree_order_key)}


def _stack(xs: List[Any]) -> Any:
    return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)


def stack_layers(flat: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """Per-layer ``{path: leaf}`` -> the stacked layout, in leaf order:
    ``blocks/<p>/<name>`` holds layers p, p + P, ... of ``blocks/<l>/<name>``
    stacked on a new leading axis (P the pattern's length). Other leaves
    pass as they are."""
    P, n = len(cfg.pattern), cfg.num_superblocks
    out, groups = {}, {}
    for path, x in flat.items():
        if path.startswith("blocks/"):
            _, l, name = path.split("/", 2)
            groups.setdefault(f"blocks/{int(l) % P}/{name}", [None] * n)[int(l) // P] = x
        else:
            out[path] = x
    for path, xs in groups.items():
        if any(x is None for x in xs):
            raise ValueError(f"{path}: {cfg.num_layers} layers do not fill the pattern's slots")
        out[path] = _stack(xs)
    return _ordered(out)


def unstack_layers(flat: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of ``stack_layers``: each stacked ``blocks/<p>/<name>``
    split into the per-layer leaves of layers p, p + P, ..."""
    P = len(cfg.pattern)
    out = {}
    for path, x in flat.items():
        if path.startswith("blocks/"):
            _, p, name = path.split("/", 2)
            for i in range(x.shape[0]):
                out[f"blocks/{i * P + int(p)}/{name}"] = x[i]
        else:
            out[path] = x
    return _ordered(out)


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
    return tuple(unflatten_tree({k: host_copy(v) for k, v in d.items()})
                 for d in (stacked, shared))


def fifo_to_numpy(fifo) -> Tuple[Any, ...]:
    """The deferred reductions ``[(g_stacked, g_shared), ...]`` as the
    reference's tuple of ``(stacked, shared)`` numpy trees."""
    return tuple(stacked_to_numpy(gs, gsh) for gs, gsh in fifo)


def fifo_from_numpy(tree: Any, device: torch.device | str = "cuda"
                    ) -> List[Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
    """The inverse of ``fifo_to_numpy``: one ``(stacked, shared)`` pair of
    float32 ``{path: tensor}`` dicts per entry, oldest first."""
    return [stacked_from_numpy(entry, device) for entry in tree]


def _ring_to_logical(q: Optional[torch.Tensor], head: int) -> Optional[np.ndarray]:
    if q is None:
        return None
    s = head % q.shape[0]
    return host_copy(torch.roll(q, -s, 0) if s else q)


QUEUES = ("grad_q", "param_q")  # a delay wrapper's rings, in the reference's key order
MOMENT_KEYS = ({"m", "v"}, {"m"})  # the moment states' key sets


def opt_state_to_numpy(state: Any) -> Any:
    """The port's optimizer state as the reference's tree of numpy copies."""
    if "head" in state:  # a ring-buffer delay wrapper
        out = {"inner": opt_state_to_numpy(state["inner"])}
        for name in QUEUES:
            if name in state:
                out[name] = [_ring_to_logical(q, state["head"]) for q in state[name]]
        return out
    if "leaves" in state:  # basis_rotation
        return {"leaves": [{k: host_copy(v) for k, v in st.items()} for st in state["leaves"]]}
    if set(state) in MOMENT_KEYS:  # {path: tensor} per moment, or one scalar
        return {k: host_copy(d) if isinstance(d, torch.Tensor)
                else unflatten_tree({p: host_copy(t) for p, t in d.items()})
                for k, d in state.items()}
    raise ValueError(f"unknown optimizer state with keys {sorted(state)}")


@torch.no_grad()
def opt_state_from_numpy(tree: Any, state: Any) -> Any:
    """Copy the reference tree's values into ``state``, a freshly initialised
    state of the same optimizer, in place, so that the restored state has
    exactly the devices, dtypes and layouts of a fresh one. Returns it."""
    if "head" in state:
        names = [n for n in QUEUES if n in state]
        if sorted(tree) != sorted(names + ["inner"]):
            raise ValueError(f"delay wrapper: keys {sorted(tree)} != {sorted(names + ['inner'])}")
        for name in names:
            if len(tree[name]) != len(state[name]):
                raise ValueError(f"delay queues {name}: leaf counts differ")
            for i, (q, a) in enumerate(zip(state[name], tree[name])):
                if (q is None) != (a is None):
                    raise ValueError(f"{name}[{i}]: present in only one of the states")
                if q is not None:
                    _fill(q, a, f"{name}[{i}]")
        state["head"] = 0
        opt_state_from_numpy(tree["inner"], state["inner"])
    elif "leaves" in state:
        if len(tree["leaves"]) != len(state["leaves"]):
            raise ValueError("basis-rotation state: leaf counts differ")
        for i, (st, src) in enumerate(zip(state["leaves"], tree["leaves"])):
            if set(st) != set(src):
                raise ValueError(f"leaves[{i}]: keys {sorted(src)} != {sorted(st)}")
            for k, v in st.items():
                _fill(v, src[k], f"leaves[{i}][{k}]")
    elif set(state) in MOMENT_KEYS:
        if set(tree) != set(state):
            raise ValueError(f"optimizer state: keys {sorted(tree)} != {sorted(state)}")
        for k, d in state.items():
            if isinstance(d, torch.Tensor):
                _fill(d, tree[k], k)
                continue
            flat = flatten_tree(tree[k])
            if set(flat) != set(d):
                raise ValueError(f"{k}: leaf paths differ")
            for p, t in d.items():
                _fill(t, flat[p], f"{k}/{p}")
    else:
        raise ValueError(f"unknown optimizer state with keys {sorted(state)}")
    return state


def stage_shard_axes(stacked: Dict[str, Any], shared: Dict[str, Any], opt_state: Any,
                     data_fifo: Optional[List[Any]] = None) -> List[Optional[int]]:
    """Per-leaf shard axes of the SPMD engine's checkpoint tree, in its leaf
    order: axis 0 for the stacked parameters and their optimizer state, axis
    1 for their stage delay queues ``(K-1, K, per, ...)`` (gradients and
    weights alike), None for the shared leaves and theirs and for a scalar
    state (stored whole in shard 0); then, for each entry of ``data_fifo``
    (the tree's third element), axis 0 for its stacked gradients and None
    for its shared ones. These are the axes the reference reads off its
    leaves' stage sharding."""
    on_stage = [True] * len(stacked) + [False] * len(shared)
    axes: List[Optional[int]] = [0 if s else None for s in on_stage]

    def queue_axes(queues):
        return [1 if s else None for s, q in zip(on_stage, queues) if q is not None]

    inner = opt_state["inner"] if "head" in opt_state else opt_state
    if "head" in opt_state:
        axes += queue_axes(opt_state["grad_q"])
    if "leaves" in inner:
        for s, st in zip(on_stage, inner["leaves"]):
            axes += [0 if s else None] * len(st)
    else:  # each moment over (stacked, shared), or one scalar; keys sorted
        for k in sorted(inner):
            axes += ([None] if isinstance(inner[k], torch.Tensor)
                     else [0 if s else None for s in on_stage])
    if "param_q" in opt_state:  # sorts after "inner"
        axes += queue_axes(opt_state["param_q"])
    for _ in data_fifo or ():
        axes += [0 if s else None for s in on_stage]
    return axes
