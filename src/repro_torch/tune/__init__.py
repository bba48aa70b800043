"""Kernel launch-plan autotuner: cost model + measured tuning, persistent
cache. Port of ``repro/tune``.

Two halves:

* **Populate** (``tune_flash`` / ``tune_matmul`` / ``tune_adam_scale``, or
  the ``python -m repro_torch.tune`` CLI): rank the launch shapes the CUDA
  kernels take — analytically via ``cost_model`` anywhere, empirically via
  ``measure`` on a card — and store the winners in the JSON cache
  (``cache.py``).
* **Consume** (``kernel_plan``): a read-only, memoised lookup. B5's wrapper
  (``kernels/adam_step.py::planned_chunk``) asks it for the chunk of every
  CUDA launch; a miss keeps its rule, so the cache is never a correctness
  or availability dependency. B1-B4 are built for one geometry each, so
  their wrappers read no plan: their entries record that geometry's cost
  or time.

Plans are keyed by ``(kernel, shape, dtype, platform)``, the platform being
the card's compute capability (``cuda-sm90`` on an H100) or ``cpu``, so a
plan measured on one card never feeds another.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.tune.cache import (  # noqa: F401
    SCHEMA,
    cache_path,
    clear_memo,
    load_cache,
    lookup,
    make_key,
    save_entries,
)
from repro_torch.tune.cost_model import (  # noqa: F401
    best_adam_plan,
    best_flash_plan,
    best_matmul_plan,
    candidate_blocks,
)


def platform_name(device: Optional[torch.device] = None) -> str:
    """``cuda-sm<major><minor>`` of ``device`` (the current card by
    default), or ``cpu`` where there is no card."""
    if device is not None and torch.device(device).type != "cuda":
        return "cpu"
    if device is None and not torch.cuda.is_available():
        return "cpu"
    major, minor = torch.cuda.get_device_capability(device)
    return f"cuda-sm{major}{minor}"


def kernel_plan(kernel: str, shape: Sequence[int], dtype: str = "float32",
                platform: Optional[str] = None,
                path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Cached plan for ``(kernel, shape, dtype, platform)``, or None.

    Read-only: launch-time code never writes the cache."""
    return lookup(kernel, tuple(int(d) for d in shape), dtype, platform or platform_name(),
                  path)


def _measured(measured: Optional[bool], platform: str) -> bool:
    """``measured=None`` picks timings on a card, the cost model elsewhere."""
    return platform.startswith("cuda") if measured is None else measured


def tune_flash(S: int, dh: int, *, batch_heads: int = 1, dtype: str = "float32",
               causal: bool = True, measured: Optional[bool] = None,
               path: Optional[str] = None, write: bool = True) -> Dict[str, Any]:
    """Cost (and on a card, time) B1-B3's geometry for (S, dh) forward plus
    backward, and by default persist it. One geometry is built for each
    (dh, dtype), so nothing is chosen: the entry records what it costs."""
    platform = platform_name()
    plan = best_flash_plan(S, dh, batch_heads=batch_heads, dtype=dtype, causal=causal)
    if _measured(measured, platform):
        from repro_torch.tune.measure import measure_flash_plan

        plan = {**plan, "us": measure_flash_plan(S, dh, batch_heads=batch_heads, dtype=dtype,
                                                 causal=causal),
                "batch_heads": batch_heads, "backend": "measured"}
    if write:
        save_entries({make_key("flash", (S, dh), dtype, platform): plan}, path)
    return plan


def tune_matmul(m: int, n: int, k: int, *, dtype: str = "float32",
                measured: Optional[bool] = None, path: Optional[str] = None,
                write: bool = True) -> Dict[str, Any]:
    """Cost (and on a card, time) B4's one geometry at (m, k) x (k, n)."""
    if dtype != "float32":
        raise ValueError(f"matmul: the kernel takes float32, not {dtype}")
    platform = platform_name()
    plan = best_matmul_plan(m, n, k)
    if _measured(measured, platform):
        from repro_torch.tune.measure import measure_matmul_plan

        plan = {**plan, "us": measure_matmul_plan(m, n, k), "backend": "measured"}
    if write:
        save_entries({make_key("matmul", (m, n, k), dtype, platform): plan}, path)
    return plan


def tune_adam_scale(elements: int, *, shapes: Optional[Sequence[Sequence[int]]] = None,
                    dtype: str = "float32", measured: Optional[bool] = None,
                    path: Optional[str] = None, write: bool = True, iters: int = 10,
                    warmup: int = 2) -> Dict[str, Any]:
    """Pick and (by default) persist B5's chunk for a launch over
    ``elements`` in all, the key ``chunk_size`` and ``planned_chunk`` read
    (``("adam_scale", (elements,), "float32", platform)``). ``shapes`` are
    the launch's leaves when measured (one flat leaf by default); the
    reference's one leaf of R x C is ``elements = R * C``. ``iters`` and
    ``warmup`` are the measured backend's runs of each chunk."""
    if dtype != "float32":
        raise ValueError(f"adam_scale: the kernel takes float32, not {dtype}")
    shapes = [tuple(s) for s in shapes] if shapes else [(int(elements),)]
    if sum(torch.Size(s).numel() for s in shapes) != elements:
        raise ValueError(f"adam_scale: leaves {shapes} do not hold {elements} elements")
    platform = platform_name()
    if _measured(measured, platform):
        from repro_torch.tune.measure import best_adam_chunk_measured

        plan = best_adam_chunk_measured(shapes, iters=iters, warmup=warmup)
    else:
        plan = best_adam_plan(elements)
    if write:
        save_entries({make_key("adam_scale", (elements,), dtype, platform): plan}, path)
    return plan
