"""The single training loop. Port of ``repro/engine/loop.py``.

    engine = SimEngine(model, opt)
    state, losses, timings = run_loop(engine, data_iter, LoopConfig(steps=300))

The per-step loss is not read back every iteration: device scalars collect
in a pending list and are converted in one batch at the log / metrics
cadence. Each step is timed apart from its data: ``data_s`` is the host time
to produce the batch (sampling and the copy to the device), ``step_s`` the
time from dispatching the step to the device finishing it, which costs one
device synchronisation per step. A checkpoint's host snapshot is timed in
``ckpt_s`` and its file write in ``write_s``, neither inside ``step_s``.

Checkpoints are snapshotted to the host on the loop thread
(``engine.checkpoint_job``: synchronous numpy copies, complete before the
next step, which rewrites the parameters and optimizer state in their own
tensors, is dispatched) and written, like the metrics files, on one
serial background writer thread. ``async_io=False`` runs every write inline:
the files are identical either way, the writer is drained before
``run_loop`` returns, and a writer exception re-raises on the loop thread.
A checkpoint's layout is the reference's, so either package resumes the
other's (``resume_if_present``).

A multi-process run drives this loop on every process in lock-step: every
process steps the engine and submits the checkpoint jobs (each writes its
own shards, and the jobs' barriers need every process's serial writer to
run them in submission order), while the log lines and the metrics file
belong to the main process alone (``launch.distributed.is_main``).
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from repro_torch.engine.base import EngineState, PipelineEngine
from repro_torch.launch.distributed import is_main


@dataclass
class LoopConfig:
    steps: int
    log_every: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    out_path: Optional[str] = None
    # constant metadata merged into the JSON metrics file (arch, optimizer...)
    out_meta: Dict[str, Any] = field(default_factory=dict)
    # write checkpoints and metrics on the background writer thread; off
    # writes them inline (the same bytes on disk)
    async_io: bool = True


@dataclass
class LoopTimings:
    data_s: List[float] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)
    ckpt_s: List[float] = field(default_factory=list)
    write_s: List[float] = field(default_factory=list)


class _AsyncWriter:
    """One serial background writer: jobs run strictly in submission order,
    so a metrics flush never overtakes the checkpoint it was batched with (a
    metrics file lagging its checkpoint forfeits the pre-resume series at
    merge time).

    A job exception is captured and re-raised on the loop thread at the
    next submit or close: a failed checkpoint fails the run."""

    def __init__(self) -> None:
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._drain, name="repro-io-writer",
                                        daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            if self._exc is not None:
                continue  # poisoned: drop the remaining jobs, surface the error
            try:
                job()
            except BaseException as e:  # noqa: BLE001 — re-raised on the loop thread
                self._exc = e

    def _check(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def submit(self, job: Callable[[], None]) -> None:
        self._check()
        self._q.put(job)

    def close(self) -> None:
        """Drain everything, stop the thread, re-raise any job failure."""
        self._q.put(None)
        self._thread.join()
        self._check()


def resume_if_present(
    engine: PipelineEngine,
    state: Optional[EngineState],
    ckpt_dir: Optional[str],
    data_iter: Optional[Iterator[Dict]] = None,
) -> Tuple[Optional[EngineState], int]:
    """Replace ``state`` with the latest checkpoint under ``ckpt_dir``, if any.

    Pass the run's ``data_iter`` to fast-forward it past the ``start_step``
    batches the interrupted run already consumed; without this a resumed run
    replays batches 0..start_step and leaves the uninterrupted curve."""
    if not ckpt_dir or not os.path.exists(os.path.join(ckpt_dir, "manifest.json")):
        return state, 0
    from repro_torch.checkpoint.ckpt import load_checkpoint

    tree, step, _ = load_checkpoint(ckpt_dir)
    if data_iter is not None:
        for _ in range(step):
            next(data_iter)
    return engine.load_state(tree), step


def _read_metrics_prefix(cfg: LoopConfig, start_step: int) -> Tuple[List[float], int]:
    """Losses for absolute steps [prev_start, start_step) from an existing
    metrics file, so that a resumed run keeps the whole absolute-step
    series. Returns (prefix, prefix_start); an empty prefix anchored at
    ``start_step`` when there is no usable file."""
    if not (cfg.out_path and start_step and os.path.exists(cfg.out_path)):
        return [], start_step
    try:
        with open(cfg.out_path) as f:
            prev = json.load(f)
        prev_losses = list(prev.get("losses", []))
        prev_start = int(prev.get("start_step", 0))
    except (ValueError, OSError, TypeError):
        return [], start_step
    need = start_step - prev_start
    if need < 0 or len(prev_losses) < need:
        return [], start_step  # a gap: the old file does not reach start_step
    return prev_losses[:need], prev_start


def _write_metrics(cfg: LoopConfig, losses: List[float], steps_done: int, start_step: int,
                   timings: Dict[str, List[float]]) -> None:
    os.makedirs(os.path.dirname(cfg.out_path) or ".", exist_ok=True)
    tmp = cfg.out_path + ".tmp"
    with open(tmp, "w") as f:
        # losses[i] is the loss at absolute step start_step + i; the timings
        # cover this run's steps only
        json.dump({**cfg.out_meta, "steps_done": steps_done, "start_step": start_step,
                   "losses": losses, **timings}, f)
    os.replace(tmp, cfg.out_path)  # a killed write never leaves a truncated file


def run_loop(
    engine: PipelineEngine,
    data_iter: Iterator[Dict],
    cfg: LoopConfig,
    state: Optional[EngineState] = None,
    start_step: int = 0,
) -> Tuple[EngineState, List[float], LoopTimings]:
    """Run ``cfg.steps`` engine steps (from ``start_step`` when resuming).
    Checkpoints after every ``ckpt_every``-th step and at ``cfg.steps``."""
    main = is_main()
    if state is None:
        state = engine.init_state()
    prefix, prefix_start = (_read_metrics_prefix(cfg, start_step) if main
                            else ([], start_step))
    losses: List[float] = []
    pending: List[Any] = []
    timings = LoopTimings()

    def flush_losses() -> None:
        losses.extend(float(x) for x in pending)
        pending.clear()

    writer = _AsyncWriter() if cfg.async_io else None

    def submit(job: Callable[[], None]) -> None:
        if writer is None:
            job()
        else:
            writer.submit(job)

    def checkpoint(step: int) -> None:
        t0 = time.perf_counter()
        write = engine.checkpoint_job(cfg.ckpt_dir, state, step=step)
        timings.ckpt_s.append(time.perf_counter() - t0)

        def timed_write() -> None:
            t1 = time.perf_counter()
            write()
            timings.write_s.append(time.perf_counter() - t1)

        submit(timed_write)

    def metrics_job(done: int) -> Callable[[], None]:
        snapshot = prefix + losses
        times = {"data_s": list(timings.data_s), "step_s": list(timings.step_s)}
        return lambda: _write_metrics(cfg, snapshot, done, prefix_start, times)

    try:
        t_start = time.perf_counter()
        for t in range(start_step, cfg.steps):
            t0 = time.perf_counter()
            batch = next(data_iter)
            t1 = time.perf_counter()
            state, loss, metrics = engine.step(state, batch, t)
            engine.synchronize()
            t2 = time.perf_counter()
            timings.data_s.append(t1 - t0)
            timings.step_s.append(t2 - t1)
            pending.append(loss)
            if main and cfg.log_every and t % cfg.log_every == 0:
                flush_losses()
                extra = f"  ce {float(metrics['ce']):.4f}" if "ce" in metrics else ""
                print(f"step {t:5d}  loss {losses[-1]:.4f}{extra}"
                      f"  ({time.perf_counter() - t_start:.1f}s)", flush=True)
            wrote_ckpt = bool(cfg.ckpt_dir and cfg.ckpt_every and (t + 1) % cfg.ckpt_every == 0)
            if wrote_ckpt:
                checkpoint(t + 1)
            # metrics are flushed at every checkpoint too, so the metrics
            # file never lags a checkpoint a later resume restarts from
            if main and cfg.out_path and (wrote_ckpt or (t + 1) % max(cfg.log_every, 1) == 0):
                flush_losses()
                submit(metrics_job(t + 1))
        flush_losses()
        if cfg.ckpt_dir:
            checkpoint(cfg.steps)
        if main and cfg.out_path:
            submit(metrics_job(cfg.steps))
    finally:
        if writer is not None:
            writer.close()
    return state, losses, timings
