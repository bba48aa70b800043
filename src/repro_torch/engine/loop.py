"""The single training loop. Port of ``repro/engine/loop.py`` for one process
without checkpoints.

    engine = SimEngine(model, opt)
    state, losses, timings = run_loop(engine, data_iter, LoopConfig(steps=300))

The per-step loss is not read back every iteration: device scalars collect
in a pending list and are converted in one batch at the log / metrics
cadence. Each step is timed apart from its data: ``data_s`` is the host time
to produce the batch (sampling and the copy to the device), ``step_s`` the
time from dispatching the step to the device finishing it, which costs one
device synchronisation per step.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.engine.base import EngineState, PipelineEngine


@dataclass
class LoopConfig:
    steps: int
    log_every: int = 0
    out_path: Optional[str] = None
    # constant metadata merged into the JSON metrics file (arch, optimizer...)
    out_meta: Dict[str, Any] = field(default_factory=dict)


@dataclass
class LoopTimings:
    data_s: List[float] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)


def _write_metrics(cfg: LoopConfig, losses: List[float], steps_done: int,
                   timings: LoopTimings) -> None:
    os.makedirs(os.path.dirname(cfg.out_path) or ".", exist_ok=True)
    tmp = cfg.out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({**cfg.out_meta, "steps_done": steps_done, "start_step": 0,
                   "losses": losses, "data_s": timings.data_s,
                   "step_s": timings.step_s}, f)
    os.replace(tmp, cfg.out_path)  # a killed write never leaves a truncated file


def run_loop(
    engine: PipelineEngine,
    data_iter: Iterator[Dict],
    cfg: LoopConfig,
    state: Optional[EngineState] = None,
) -> Tuple[EngineState, List[float], LoopTimings]:
    """Run ``cfg.steps`` engine steps from step 0."""
    if state is None:
        state = engine.init_state()
    losses: List[float] = []
    pending: List[Any] = []
    timings = LoopTimings()

    def flush_losses() -> None:
        losses.extend(float(x) for x in pending)
        pending.clear()

    t_start = time.perf_counter()
    for t in range(cfg.steps):
        t0 = time.perf_counter()
        batch = next(data_iter)
        t1 = time.perf_counter()
        state, loss, metrics = engine.step(state, batch, t)
        engine.synchronize()
        t2 = time.perf_counter()
        timings.data_s.append(t1 - t0)
        timings.step_s.append(t2 - t1)
        pending.append(loss)
        if cfg.log_every and t % cfg.log_every == 0:
            flush_losses()
            extra = f"  ce {float(metrics['ce']):.4f}" if "ce" in metrics else ""
            print(f"step {t:5d}  loss {losses[-1]:.4f}{extra}"
                  f"  ({time.perf_counter() - t_start:.1f}s)", flush=True)
        if cfg.out_path and (t + 1) % max(cfg.log_every, 1) == 0:
            flush_losses()
            _write_metrics(cfg, losses, t + 1, timings)
    flush_losses()
    if cfg.out_path:
        _write_metrics(cfg, losses, cfg.steps, timings)
    return state, losses, timings
