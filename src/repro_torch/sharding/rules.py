"""Sharding rules: what each device of the reference's production mesh holds
of every parameter, optimizer-state leaf, batch and decode cache. Port of
``repro/sharding/rules.py``.

Scheme (MaxText-style, DESIGN.md §4):
  * batch over ("pod", "data") — pure data parallel between pods;
  * weights tensor-parallel over "model": attention q/k/v output dim, o input
    dim, MLP hidden dim, MoE expert dim (or expert-hidden when the expert
    count doesn't divide the axis), vocab dim for embedding/head;
  * the "data" axis doubles as an FSDP axis for weights and optimizer state
    (the second matrix dim is sharded over "data" when divisible) — required
    to fit the 34B/236B configs;
  * basis-rotation state: m/v follow the parameter; U/L live on the row space
    (sharded like the rows), V/R on the column space.

Every rule degrades to None when the dimension doesn't divide the axis size,
so the same rules serve the 16x16 production mesh, the 2x16x16 multi-pod
mesh, and single-device smoke tests.

A spec is a plain tuple with one entry per dimension (or fewer, trailing
dimensions unsharded): ``None``, an axis name, or a tuple of two or more
axis names — the tuple that the reference's ``PartitionSpec`` is (which
stores a tuple of one axis as that axis, and an empty one as ``None``). A tree of specs has
the shape of the tree it describes: the port's parameters are an ordered
``{path: tensor}`` dict (``models.model.param_leaves``, the reference's
paths in its flatten order), its optimizer state dicts and lists of such.
The port has no tensor-parallel runtime: ``shard_shape`` and
``sharded_bytes`` say what one device of a mesh would hold under the
specs, which the dry run reports (the reference reads it from XLA's
per-device memory analysis).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]

# parameter-name classification -------------------------------------------------

COL_SHARDED = (  # output dim (last) over "model"
    "w_q",
    "w_k",
    "w_v",
    "w_gate",
    "w_up",
    "q_a",
    "q_b",
    "kv_a",
    "kv_b",
    "in_proj",
    "up_proj",
    "x_proj",
    "dt_proj",
    "w_x",
    "ff_up",
    "w_i",
    "w_f",
)
ROW_SHARDED = (  # input dim (second-to-last) over "model"
    "w_o",
    "w_down",
    "out_proj",
    "down_proj",
    "ff_down",
)
EXPERT_SHARDED = ("w_gate_e", "w_up_e", "w_down_e")


def _spec(entries) -> Spec:
    """A spec in ``PartitionSpec``'s canonical form."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                 else None if isinstance(e, tuple) and not e else e for e in entries)


def _div(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _axis(mesh_shape: Dict[str, int], name: str, dim: int) -> Optional[str]:
    return name if name in mesh_shape and _div(dim, mesh_shape[name]) else None


def param_pspec(path: str, shape: Sequence[int], mesh_shape: Dict[str, int]) -> Spec:
    """Spec for a parameter leaf at reference path ``path``."""
    shape = tuple(int(d) for d in shape)
    nd = len(shape)
    leaf = path.split("/")[-1]
    spec: List[Optional[Any]] = [None] * nd

    def set_last2(row_axis, col_axis):
        if nd >= 2:
            spec[-2] = row_axis
            spec[-1] = col_axis

    if "embedding" in path:
        # (V, d) or (K, V, d): vocab over model, d over data (FSDP)
        if nd >= 2:
            spec[-2] = _axis(mesh_shape, "model", shape[-2])
            spec[-1] = _axis(mesh_shape, "data", shape[-1])
    elif leaf == "lm_head":
        set_last2(_axis(mesh_shape, "data", shape[-2]), _axis(mesh_shape, "model", shape[-1]))
    elif leaf in EXPERT_SHARDED and nd >= 3:
        e_ax = _axis(mesh_shape, "model", shape[-3])
        if e_ax:  # expert parallelism
            spec[-3] = e_ax
            spec[-2] = _axis(mesh_shape, "data", shape[-2])
        else:  # few experts: shard the expert-hidden dim instead
            hid = -1 if leaf != "w_down_e" else -2
            oth = -2 if leaf != "w_down_e" else -1
            spec[hid] = _axis(mesh_shape, "model", shape[hid])
            spec[oth] = _axis(mesh_shape, "data", shape[oth])
    elif leaf in ROW_SHARDED and nd >= 2:
        set_last2(_axis(mesh_shape, "model", shape[-2]), _axis(mesh_shape, "data", shape[-1]))
    elif leaf in COL_SHARDED and nd >= 2:
        set_last2(_axis(mesh_shape, "data", shape[-2]), _axis(mesh_shape, "model", shape[-1]))
    elif leaf == "w_r" and nd >= 3:  # sLSTM block-diagonal recurrent (H, dh, 4dh)
        spec[-1] = _axis(mesh_shape, "model", shape[-1])
    elif leaf in ("A_log", "D", "conv_w", "conv_b", "dt_bias"):
        # Mamba per-channel params: shard d_inner over model
        for i, s in enumerate(shape):
            ax = _axis(mesh_shape, "model", s)
            if ax and s >= 64:
                spec[i] = ax
                break
    # norms / biases / small vectors: replicated
    return tuple(spec)


def params_pspecs(params: Dict[str, torch.Tensor], mesh_shape: Dict[str, int]
                  ) -> Dict[str, Spec]:
    """``{path: spec}`` for the port's ``{path: tensor}`` parameters (any
    device, ``meta`` included: only shapes are read), in their order.
    Stacked leaves keep their leading superblock axis unsharded, as the
    reference's stacked leaves do."""
    return {path: param_pspec(path, tuple(x.shape), mesh_shape) for path, x in params.items()}


# optimizer state ---------------------------------------------------------------


def rotation_state_pspec(
    name: str, param_spec: Spec, shape: Sequence[int], mesh_shape: Dict[str, int]
) -> Spec:
    """Spec for a basis-rotation state leaf given its parameter's spec."""
    shape = tuple(int(d) for d in shape)
    if name in ("m", "v"):
        return param_spec
    batch = list(param_spec[:-2]) if len(param_spec) >= 2 else []
    batch += [None] * (len(shape) - 2 - len(batch))
    if name in ("U", "L"):  # row space (m x m): shard rows over data (FSDP)
        return (*batch, _axis(mesh_shape, "data", shape[-2]), None)
    if name in ("V", "R"):  # column space (n x n)
        return (*batch, _axis(mesh_shape, "data", shape[-2]), None)
    return ()


def _is_scalar(x) -> bool:
    return isinstance(x, torch.Tensor) and x.ndim == 0


def opt_state_pspecs(opt_state: Any, params: Dict[str, torch.Tensor],
                     mesh_shape: Dict[str, int]) -> Any:
    """Specs for any optimizer state of ``repro_torch.optim`` /
    ``repro_torch.core``, in the state's own structure.

    Works structurally, as the reference's does: a ``"leaves"`` list (basis
    rotation) maps to the parameters' order; m/v trees mirror the parameter
    dict (a scalar v, the unilateral first-moment variant's, gets ``()``);
    a list as long as the parameters is a list of delay rings, each slot
    taking its parameter's spec behind a leading ``None`` (the ring's
    depth), ``None`` where a leaf has no ring. The port's rings carry a
    ``"head"`` beside them, a scalar like every other non-tensor leaf: ``()``.
    """
    pspecs = params_pspecs(params, mesh_shape)
    sflat = list(pspecs.values())

    def rec(state):
        if state is None:
            return None
        if isinstance(state, dict):
            if "leaves" in state and isinstance(state["leaves"], list):
                out = dict(state)
                out["leaves"] = [
                    {k: rotation_state_pspec(k, spec, tuple(v.shape), mesh_shape)
                     for k, v in leaf_state.items()}
                    for leaf_state, spec in zip(state["leaves"], sflat)
                ]
                return out
            if "m" in state and "v" in state:
                out = dict(state)
                out["m"] = dict(pspecs)
                out["v"] = () if _is_scalar(state["v"]) else dict(pspecs)
                for k in state:
                    if k not in ("m", "v"):
                        out[k] = rec(state[k])
                return out
            return {k: rec(v) for k, v in state.items()}
        if isinstance(state, (list, tuple)):
            # delay rings: leading FIFO dim + param spec
            if len(state) == len(sflat):
                out = [None if q is None else (None, *spec) for q, spec in zip(state, sflat)]
                return out if isinstance(state, list) else tuple(out)
            t = [rec(x) for x in state]
            return t if isinstance(state, list) else tuple(t)
        return ()  # scalar leaf

    return rec(opt_state)


# inputs / caches ---------------------------------------------------------------


def batch_axes(mesh_shape: Dict[str, int]) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_shape)


def tokens_pspec(batch: int, mesh_shape: Dict[str, int], extra_dims: int = 1) -> Spec:
    axes = batch_axes(mesh_shape)
    total = 1
    for a in axes:
        total *= mesh_shape[a]
    b_ax = axes if _div(batch, total) else None
    return _spec((b_ax, *([None] * extra_dims)))


def generic_activation_pspec(
    shape: Sequence[int], mesh_shape: Dict[str, int], batch_dim: int = 0
) -> Spec:
    """Shard batch over (pod,data) if divisible; largest remaining dim over model."""
    shape = tuple(int(d) for d in shape)
    spec: List[Optional[Any]] = [None] * len(shape)
    axes = batch_axes(mesh_shape)
    total = 1
    for a in axes:
        total *= mesh_shape[a]
    if _div(shape[batch_dim], total):
        spec[batch_dim] = axes
    best, best_dim = None, -1
    for i, s in enumerate(shape):
        if i == batch_dim:
            continue
        if _div(s, mesh_shape.get("model", 0)) and s > best_dim:
            best, best_dim = i, s
    if best is not None:
        spec[best] = "model"
    return _spec(spec)


def cache_pspecs(cache: Any, mesh_shape: Dict[str, int], stacked: bool = True) -> Any:
    """Specs for a decode cache (``models.model.init_cache``: a tuple of
    dicts of tensors), in its structure. Stacked caches have a leading
    superblock axis: (L, B, ...) vs (B, ...)."""
    bd = 1 if stacked else 0

    def rec(x):
        if isinstance(x, torch.Tensor):
            return generic_activation_pspec(tuple(x.shape), mesh_shape, batch_dim=bd)
        if isinstance(x, dict):
            return {k: rec(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            t = [rec(v) for v in x]
            return t if isinstance(x, list) else tuple(t)
        return x

    return rec(cache)


# one device's share ---------------------------------------------------------------


def shard_shape(shape: Sequence[int], spec: Spec, mesh_shape: Dict[str, int]
                ) -> Tuple[int, ...]:
    """One device's block of a tensor of ``shape`` under ``spec``: each
    dimension divided by the product of the axes it is sharded over (the
    rules shard only dimensions that divide). Axes the mesh lacks count 1."""
    shape = tuple(int(d) for d in shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = list(shape)
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        n = math.prod(mesh_shape.get(a, 1) for a in (axes if isinstance(axes, tuple)
                                                     else (axes,)))
        if out[i] % n:
            raise ValueError(f"dim {i} of {shape} does not divide over {axes} ({n})")
        out[i] //= n
    return tuple(out)


def _pairs(tree: Any, specs: Any):
    """(tensor, spec) for every tensor of ``tree``, walking ``specs`` beside it."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        if len(tree) != len(specs):
            raise ValueError(f"tree of {len(tree)} items beside specs of {len(specs)}")
        for v, s in zip(tree, specs):
            yield from _pairs(v, s)


def sharded_bytes(tree: Any, specs: Any, mesh_shape: Dict[str, int]) -> int:
    """Bytes that one device holds of the tensors of ``tree`` under
    ``specs`` (a tree of the same structure; non-tensor leaves hold none)."""
    return sum(math.prod(shard_shape(t.shape, s, mesh_shape)) * t.element_size()
               for t, s in _pairs(tree, specs))
