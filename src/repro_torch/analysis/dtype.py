"""The float-dtype discipline of a training step. Port of ``DtypePolicy``,
``F32_POLICY``, ``BF16_COMPUTE_POLICY`` and ``check_dtype_policy`` in
``repro/analysis/jaxpr.py``.

The reference reads the float dtypes off a step's jaxpr. PyTorch runs
eagerly, so ``record_float_dtypes`` runs the step once under a
``TorchDispatchMode`` and counts the float dtype of every operation's
outputs, forward and backward. ``check_dtype_policy`` then holds those
counts, and the dtypes of the state the step reads and writes (parameter
masters and optimizer state), to a ``DtypePolicy``.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

Tensor = torch.Tensor


@dataclass(frozen=True)
class DtypePolicy:
    """Float-dtype discipline for one step.

    ``allowed_float`` bounds every float intermediate, ``forbidden`` is
    rejected anywhere (float64 creeps in through numpy scalars), and
    ``state_dtype``, when set, pins the dtype of every float state tensor:
    parameter masters and optimizer state. ``require_present`` lists dtypes
    that must appear among the intermediates, so that a bf16-compute step
    with no bf16 anywhere fails instead of passing vacuously.
    """

    allowed_float: Tuple[str, ...] = ("float32",)
    forbidden: Tuple[str, ...] = ("float64",)  # lint: allow-float64
    state_dtype: Optional[str] = "float32"
    require_present: Tuple[str, ...] = ()


F32_POLICY = DtypePolicy()
BF16_COMPUTE_POLICY = DtypePolicy(allowed_float=("float32", "bfloat16"), state_dtype="float32",
                                  require_present=("bfloat16",))


@dataclass
class CheckResult:
    name: str
    passed: bool
    detail: str = ""
    data: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "passed": self.passed, "detail": self.detail,
                "data": self.data}


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


class _FloatDtypes(TorchDispatchMode):
    """Counts the float dtypes of every dispatched operation's outputs."""

    def __init__(self):
        super().__init__()
        self.seen: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in tree_flatten(out)[0]:
            if isinstance(x, Tensor) and x.is_floating_point():
                self.seen[_dtype_name(x.dtype)] += 1
        return out


def record_float_dtypes(fn: Callable, *args, **kwargs) -> Tuple[Any, Dict[str, int]]:
    """``fn(*args, **kwargs)`` and the count of operation outputs of each
    float dtype during the call (its backward passes included)."""
    mode = _FloatDtypes()
    with mode:
        out = fn(*args, **kwargs)
    return out, dict(mode.seen)


def state_leaves(tree: Any, prefix: str = "") -> Dict[str, Tensor]:
    """``{path: tensor}`` of every tensor in a nest of dicts, lists and
    tuples, such as an engine state's parameters and optimizer state."""
    if isinstance(tree, Tensor):
        return {prefix: tree}
    items = (tree.items() if isinstance(tree, Mapping)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    out: Dict[str, Tensor] = {}
    for k, v in items:
        out.update(state_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def check_dtype_policy(seen: Mapping[str, int], state: Optional[Mapping[str, Tensor]] = None,
                       policy: DtypePolicy = F32_POLICY,
                       name: str = "dtype_policy") -> CheckResult:
    """Every float dtype in ``seen`` (``record_float_dtypes``' counts) and
    every float tensor of ``state`` (``{path: tensor}``) satisfy the policy."""
    bad = []
    for dt, n in seen.items():
        if dt in policy.forbidden:
            bad.append(f"forbidden dtype {dt} appears {n}x")
        elif dt not in policy.allowed_float:
            bad.append(f"dtype {dt} not in allowed set {policy.allowed_float}")
    for dt in policy.require_present:
        if dt not in seen:
            bad.append(f"required dtype {dt} appears nowhere (policy is vacuous)")
    if policy.state_dtype is not None:
        for path, x in (state or {}).items():
            if x.is_floating_point() and _dtype_name(x.dtype) != policy.state_dtype:
                bad.append(f"state {path} has state dtype {_dtype_name(x.dtype)}, "
                           f"policy requires {policy.state_dtype}")
    return CheckResult(name, not bad, "; ".join(bad), {"float_dtypes": dict(seen)})
