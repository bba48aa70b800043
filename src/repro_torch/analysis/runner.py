"""Matrix driver: audit the real engine over the engine matrix. Port of
``repro/analysis/runner.py``.

``python -m repro_torch.analysis --matrix smoke`` records the REAL
``SpmdEngine`` step, not a mock, over the reference's cross-product

    {fill_drain, 1f1b} x {sync, async} x
    {adam, basis_rotation, pipedream_lr, delay_compensation, nesterov_pp} x
    {1pod, 2pod}

plus the asynchronous-data-axis cells, {fill_drain, 1f1b} x {adam,
nesterov_pp} x {2data, 2pod} with ``data_async=True, data_delay=1``, where
the step and the deferred reduction must show that the data-axes gradient
all-reduce left the step without being lost (``--data-async-only`` runs
just these), on the reference's tiny shapes (2 stages, 2 microbatches of 8
tokens, d_model 16, vocab 96). It runs every named check of
``analysis.trace`` and ``analysis.collectives``, the AST lint, and writes
one JSON report; the exit status is nonzero if anything fails.

Which checks run where:

* per cell, in this process: ``dtype_policy``, ``no_dot_outside_cond`` and
  ``stash_bound`` per the schedule's declared invariants
  (``engine.schedules.SCHEDULE_INVARIANTS``), on one step recorded by
  ``analysis.trace.record_step``; a topology's data replicas run in this
  process, each on its rows of every microbatch.
* per cell, on one rank per device position of the topology over gloo:
  ``collective_axes``, ``data_reduction`` (with ``async_data_reduction``
  and ``collective_axes_reduce`` in the data-async cells) on the
  transport's records, and ``donation`` (``SpmdEngine(donate=True)`` keeps
  every parameter's and optimizer-state tensor's storage). The ranks start
  through the port's launcher (``launch.spawn.launch_phase``, the
  ``REPRO_*`` environment of ``launch.distributed``) once per topology,
  two for 1pod and four each for 2data and 2pod, and run all of that
  topology's cells. ``--no-hlo`` skips them, as the reference skips its
  compiled-HLO checks.
* per (schedule, topology): ``scan_body_constant_in_microbatches`` on the
  schedule's gradient at two microbatch counts, on the meta device.
* per precision cell (bf16 with kernels, f32 with kernels, bf16 without):
  the dtype policy of its precision and, with kernels, ``kernel_in_scan``.
* once: the AST lint over ``src/repro_torch``.

``--device`` is the card unless ``--device cpu``, as for
``launch/train.py``. On the card the matrix cells run the kernel path
(``use_kernels``: B1-B3 in attention, B4 and B5 in basis rotation's
update), and each record bills the launch counters of B1-B5 to tick scopes
or outside (the report's ``launches``); on the CPU they audit the engine
the reference's cells audit, without kernels. The kernel cells take their
own ``use_kernels`` on either device (plain versions on the CPU).
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.dtype import (
    BF16_COMPUTE_POLICY,
    F32_POLICY,
    CheckResult,
    check_dtype_policy,
    state_leaves,
)
from repro_torch.analysis.trace import (
    StepRecord,
    check_kernel_in_scan,
    check_no_dot_outside_cond,
    check_scan_body_constant_in_microbatches,
    check_stash_bound,
    kernel_launch_counts,
    record_step,
)

SCHEDULES = ("fill_drain", "1f1b")
SYNC_MODES = ("sync", "async")
OPTIMIZERS = (
    "adam", "basis_rotation", "pipedream_lr", "delay_compensation",
    "nesterov_pp",
)
TOPOLOGIES = ("1pod", "2pod")
# async-data cells need topologies with more than one data shard: "2data"
# splits the data axis proper, "2pod" reduces over ("pod", "data")
DATA_ASYNC_TOPOLOGIES = ("2data", "2pod")
DATA_ASYNC_OPTIMIZERS = ("adam", "nesterov_pp")
_DATA_DELAY = 1
# kernel-backed and mixed-precision configurations audited on top of the
# base matrix: (precision, use_kernels) per schedule
PRECISION_CELLS = (("bf16", True), ("f32", True), ("bf16", False))

# the reference's smallest shapes that keep every invariant observable:
# vocab distinct from every other dimension, 2 stages so the delay FIFO,
# the last-stage gate and the stash are all non-trivial
_K = 2
_M = 2
_SEQ = 8
_M_SCALING = (2, 6)  # microbatch counts for the O(1)-in-M check
_RANK_TIMEOUT = 600.0  # seconds one topology's ranks may take


def _tiny_model_cfg():
    from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig

    return ModelConfig(
        num_layers=2, d_model=16, d_ff=24, vocab_size=96, max_seq_len=32,
        attention=AttentionConfig(num_heads=2, num_kv_heads=2, head_dim=8),
        pattern=(BlockSpec("attn", "dense"),), scan_layers=False,
    )


def _opt_cfg(name: str):
    from repro_torch.configs.base import OptimizerConfig

    kw: Dict[str, Any] = dict(name=name, learning_rate=1e-3, total_steps=4,
                              schedule="constant")
    if name == "basis_rotation":
        kw.update(rotation_freq=2, stage_aware=True)
    return OptimizerConfig(**kw)


# label -> (stages, data, pods); "1stage2data" is the data axis alone
TOPOLOGY_SHAPES = {"1pod": (_K, 1, 1), "2pod": (_K, 1, 2), "2data": (_K, 2, 1),
                   "1stage2data": (1, 2, 1)}


def _topology(label: str):
    from repro_torch.launch.topology import Topology

    if label not in TOPOLOGY_SHAPES:
        raise ValueError(f"unknown topology label {label!r}")
    stages, data, pods = TOPOLOGY_SHAPES[label]
    return Topology(stages=stages, data=data, pods=pods)


def _batch(topo, m: int, device) -> Dict[str, torch.Tensor]:
    """A fixed global batch: (M, one row per data shard, S) tokens and labels."""
    rng = np.random.RandomState(0)
    shape = (m, topo.data_shards, _SEQ)
    return {k: torch.from_numpy(rng.randint(0, _tiny_model_cfg().vocab_size, size=shape))
            .to(device) for k in ("tokens", "labels")}


def _engine(schedule: str, opt_name: str, topo_label: str, device, *, async_grads=True,
            data_async=False, use_kernels=False, precision=None):
    from repro_torch.engine.spmd import SpmdEngine

    kw = dict(data_async=True, data_delay=_DATA_DELAY) if data_async else {}
    # donate=True explicitly (not "auto"): the donation check audits the
    # in-place step on every device, the CPU included
    topo = _topology(topo_label)
    return SpmdEngine(_tiny_model_cfg(), _opt_cfg(opt_name), num_stages=topo.stages,
                      num_microbatches=_M, schedule=schedule, async_grads=async_grads,
                      use_kernels=use_kernels, precision=precision, device=device, donate=True,
                      topology=topo, **kw)


def _record(engine, device) -> Tuple[StepRecord, Any]:
    """One step of ``engine`` from its initial state, recorded."""
    state = engine.init_state()
    counters = kernel_launch_counts if device.type == "cuda" else None
    (new_state, _loss, _m), rec = record_step(
        engine.step, state, _batch(engine.topology, _M, device), 0, counters=counters)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return rec, new_state


def _state(state) -> Dict[str, torch.Tensor]:
    return state_leaves({"params": state.params, "opt": state.opt_state})


# ---------------------------------------------------------------------------
# Cell + grid audits (one process)
# ---------------------------------------------------------------------------


def audit_schedule_scaling(schedule: str, topo_label: str) -> CheckResult:
    """O(1)-in-M check on the schedule's gradient, its data replicas run in
    this process, traced on the meta device."""
    from repro_torch.engine.schedules import (
        SCHEDULE_INVARIANTS,
        make_local_grad,
        make_schedule_grad,
    )
    from repro_torch.engine.spmd import stack_stage_params
    from repro_torch.models.model import Transformer, param_leaves

    cfg = _tiny_model_cfg()
    topo = _topology(topo_label)
    stacked, shared = stack_stage_params(
        param_leaves(Transformer(cfg, device="meta", seed=None)), cfg, _K)
    records = {}
    for m in _M_SCALING:
        gf = make_local_grad(make_schedule_grad(cfg, _K, m, schedule), topo.data_shards)
        tok = torch.zeros((m, topo.data_shards, _SEQ), dtype=torch.int64, device="meta")
        _, records[m] = record_step(gf, stacked, shared, {"tokens": tok, "labels": tok},
                                    held=(stacked, shared, tok), track_memory=True)
    return check_scan_body_constant_in_microbatches(
        records, expect_const_bytes=SCHEDULE_INVARIANTS[schedule]["const_float_bytes_in_M"])


def _structure_checks(rec: StepRecord, schedule: str, sites: int = 0,
                      stash: bool = True) -> List[CheckResult]:
    from repro_torch.engine.schedules import SCHEDULE_INVARIANTS

    inv = SCHEDULE_INVARIANTS[schedule]  # KeyError = undeclared schedule
    cfg = _tiny_model_cfg()
    out = []
    if sites:
        out.append(check_kernel_in_scan(rec, sites=sites))
    out.append(check_no_dot_outside_cond(rec, cfg.vocab_size,
                                         require_gated=inv["vocab_dot_gated"]))
    if stash and inv["stash_bound"]:
        # each data replica runs its own rows: 1-row activations
        out.append(check_stash_bound(rec, _K, (1, _SEQ, cfg.d_model)))
    return out


def audit_cell(schedule: str, sync_mode: str, opt_name: str, topo_label: str,
               device) -> Tuple[List[CheckResult], Dict]:
    """The one-process checks of one matrix cell against the real
    SpmdEngine step, and the step's launches (the card's)."""
    engine = _engine(schedule, opt_name, topo_label, device, async_grads=(sync_mode == "async"),
                     use_kernels=device.type == "cuda")
    rec, state = _record(engine, device)
    results = [check_dtype_policy(rec.float_dtypes, _state(state), F32_POLICY)]
    return results + _structure_checks(rec, schedule), _launch_report(rec)


def audit_data_async_cell(schedule: str, opt_name: str, topo_label: str,
                          device) -> Tuple[List[CheckResult], Dict]:
    """The one-process checks of one asynchronous-data-axis cell."""
    engine = _engine(schedule, opt_name, topo_label, device, data_async=True,
                     use_kernels=device.type == "cuda")
    rec, state = _record(engine, device)
    results = [check_dtype_policy(rec.float_dtypes, _state(state), F32_POLICY)]
    return results + _structure_checks(rec, schedule, stash=False), _launch_report(rec)


def audit_precision_cell(schedule: str, precision: str, use_kernels: bool,
                         device) -> Tuple[List[CheckResult], Dict]:
    """Dtype-policy and kernel-placement checks on a precision/kernel cell
    (1pod, Adam, synchronous). The 1F1B structural invariants are checked
    again: a kernel inside the ticks is the kind of rewrite that could
    break them."""
    engine = _engine(schedule, "adam", "1pod", device, async_grads=False,
                     use_kernels=use_kernels, precision=precision)
    rec, state = _record(engine, device)
    policy = BF16_COMPUTE_POLICY if precision == "bf16" else F32_POLICY
    results = [check_dtype_policy(rec.float_dtypes, _state(state), policy)]
    sites = _tiny_model_cfg().num_layers if use_kernels else 0
    return results + _structure_checks(rec, schedule, sites), _launch_report(rec)


def _launch_report(rec: StepRecord) -> Dict:
    """The launches of B1-B5 in tick scopes and outside, and per tick."""
    if not rec.launches:
        return {}
    return {"ticks": rec.ticks, "launches": rec.launches,
            "in_ticks_per_tick": {k: v["in_ticks"] / max(rec.ticks, 1)
                                  for k, v in rec.launches.items()}}


# ---------------------------------------------------------------------------
# Collective and donation audits (one rank per device position)
# ---------------------------------------------------------------------------


def _rank_cells(topo_label: str, opts, data_async_only: bool) -> List[Dict[str, Any]]:
    """The cells one topology's ranks audit."""
    cells = []
    if not data_async_only and topo_label in TOPOLOGIES:
        cells += [{"schedule": s, "sync": y, "optimizer": o, "data_async": False}
                  for s, y, o in itertools.product(SCHEDULES, SYNC_MODES, opts)]
    if topo_label in DATA_ASYNC_TOPOLOGIES:
        cells += [{"schedule": s, "sync": "async", "optimizer": o, "data_async": True}
                  for s, o in itertools.product(SCHEDULES, DATA_ASYNC_OPTIMIZERS)]
    return cells


def cell_key(cell: Dict[str, Any]) -> str:
    return "/".join([cell["schedule"], cell["sync"], cell["optimizer"],
                     "data_async" if cell["data_async"] else "sync_data"])


def rank_worker(topo_label: str, cells_json: str, out_dir: str, device_name: str) -> int:
    """One rank of a topology's collective audit (started by
    ``run_ranks``): per cell, build the engine, record the transport's
    calls, the state's storages and the losses over its steps (D + 2 under
    a deferred reduction, so that a reduction that was in flight reaches a
    loss), and write them to ``out_dir/rank<I>.json``."""
    from repro_torch.analysis.collectives import TransportRecorder, storage_ptrs
    from repro_torch.launch import distributed
    from repro_torch.launch.train import resolve_device

    grid = distributed.init_distributed(device=torch.device(device_name))
    device = resolve_device(device_name, grid.process_index)
    torch.set_num_threads(1)
    out = {}
    try:
        for cell in json.loads(cells_json):
            engine = _engine(cell["schedule"], cell["optimizer"], topo_label, device,
                             async_grads=cell["sync"] == "async",
                             data_async=cell["data_async"],
                             use_kernels=device.type == "cuda")
            lo, hi = engine.slab.data_shards
            batch = {k: v[:, lo:hi] for k, v in _batch(engine.topology, _M, device).items()}
            # the first state stays alive until its storages are compared,
            # so that no new tensor can take the address of a freed one
            first = state = engine.init_state()
            before = storage_ptrs(first)
            rec = engine.transport.recorder = TransportRecorder(grid.process_index)
            losses = []
            try:
                for t in range(_DATA_DELAY + 2 if cell["data_async"] else 1):
                    state, loss, _ = engine.step(state, batch, t)
                    losses.append(loss)
                losses = [float(x) for x in losses]
            finally:
                engine.transport.recorder = None
            out[cell_key(cell)] = {"records": rec.records, "before": before,
                                   "after": storage_ptrs(state), "losses": losses}
            del first, state
        with open(os.path.join(out_dir, f"rank{grid.process_index}.json"), "w") as f:
            json.dump(out, f)
    finally:
        distributed.shutdown()
    return 0


def run_ranks(topo_label: str, cells: List[Dict[str, Any]], device_name: str
              ) -> Dict[int, Dict[str, Any]]:
    """Start one rank per device position of the topology through the
    port's launcher, let them audit ``cells``, and return each rank's
    records by cell."""
    from repro_torch.launch.spawn import launch_phase, wait_all

    P = _topology(topo_label).num_devices
    with tempfile.TemporaryDirectory(prefix="repro_torch_audit_") as out_dir:
        procs = launch_phase(P, ["--rank-worker", topo_label, "--cells", json.dumps(cells),
                                 "--rank-out", out_dir, "--device", device_name],
                             module="repro_torch.analysis")
        if not wait_all(procs, time.time() + _RANK_TIMEOUT):
            raise RuntimeError(f"the {P} ranks of topology {topo_label} failed "
                               f"(exit codes {[p.returncode for p in procs]})")
        per_rank = {}
        for r in range(P):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                per_rank[r] = json.load(f)
    return per_rank


def collective_checks(per_rank: Dict[int, Dict[str, Any]], topo_label: str,
                      cell: Dict[str, Any]) -> List[CheckResult]:
    """The collective and donation checks of one cell from its ranks' records."""
    from repro_torch.analysis.collectives import (
        check_async_step_reduction,
        check_collective_axes,
        check_data_reduction,
        check_donation,
        instructions,
    )

    topo = _topology(topo_label)
    key = cell_key(cell)
    records = {r: v[key]["records"] for r, v in per_rank.items()}
    donation = [check_donation(v[key]["before"], v[key]["after"]) for v in per_rank.values()]
    worst = next((d for d in donation if not d.passed), donation[0])
    if not cell["data_async"]:
        instrs = instructions(records, topo)
        return [check_collective_axes(instrs, topo), check_data_reduction(instrs, topo), worst]
    step, reduce_ = instructions(records, topo, "step"), instructions(records, topo, "reduce")
    return [check_collective_axes(step, topo),
            check_collective_axes(reduce_, topo, name="collective_axes_reduce"),
            check_data_reduction(step, topo, deferred=True),
            check_async_step_reduction(step, reduce_, topo), worst]


# ---------------------------------------------------------------------------
# The matrix
# ---------------------------------------------------------------------------


def run_matrix(matrix: str = "smoke", optimizers: Optional[Tuple[str, ...]] = None,
               compile_hlo: bool = True, verbose: bool = True, data_async_only: bool = False,
               device: Any = "cpu") -> Dict[str, Any]:
    """Run the grid and the lint; return the JSON-able report.
    ``compile_hlo=False`` (``--no-hlo``) skips the ranks' collective and
    donation checks; ``data_async_only`` runs just the async-data cells and
    the lint."""
    from repro_torch.analysis.lint import check_repo_lint

    if matrix != "smoke":
        raise ValueError(f"unknown matrix {matrix!r} (only 'smoke' exists)")
    device = torch.device(device)
    opts = optimizers or OPTIMIZERS
    t_start = time.perf_counter()
    report: Dict[str, Any] = {"matrix": matrix, "device": str(device), "cells": [],
                              "scaling": [], "precision": [], "data_async": [],
                              "lint": None, "passed": True}

    def note(tag: str, results: List[CheckResult]):
        ok = all(r.passed for r in results)
        report["passed"] = report["passed"] and ok
        if verbose:
            states = ", ".join(f"{r.name}={'PASS' if r.passed else 'FAIL'}" for r in results)
            print(f"[{'ok' if ok else 'FAIL'}] {tag}: {states}", flush=True)
            for r in results:
                if not r.passed:
                    print(f"    {r.name}: {r.detail}", flush=True)
        return ok

    ranks: Dict[str, Dict[int, Dict[str, Any]]] = {}
    if compile_hlo:
        topos = DATA_ASYNC_TOPOLOGIES if data_async_only else \
            tuple(dict.fromkeys(TOPOLOGIES + DATA_ASYNC_TOPOLOGIES))
        for label in topos:
            t0 = time.perf_counter()
            ranks[label] = run_ranks(label, _rank_cells(label, opts, data_async_only), device.type)
            report.setdefault("rank_seconds", {})[label] = time.perf_counter() - t0

    def data_async_cells():
        for schedule, opt_name, topo_label in itertools.product(
                SCHEDULES, DATA_ASYNC_OPTIMIZERS, DATA_ASYNC_TOPOLOGIES):
            results, launches = audit_data_async_cell(schedule, opt_name, topo_label, device)
            if compile_hlo:
                results += collective_checks(ranks[topo_label], topo_label, {
                    "schedule": schedule, "sync": "async", "optimizer": opt_name,
                    "data_async": True})
            note(f"data_async {schedule}/{opt_name}/{topo_label}", results)
            report["data_async"].append({
                "schedule": schedule, "optimizer": opt_name, "topology": topo_label,
                "data_delay": _DATA_DELAY, "checks": [r.to_json() for r in results],
                **launches})

    if not data_async_only:
        for schedule, topo_label in itertools.product(SCHEDULES, TOPOLOGIES):
            res = audit_schedule_scaling(schedule, topo_label)
            note(f"scaling {schedule}/{topo_label}", [res])
            report["scaling"].append({"schedule": schedule, "topology": topo_label,
                                      "checks": [res.to_json()]})

        for schedule, sync_mode, opt_name, topo_label in itertools.product(
                SCHEDULES, SYNC_MODES, opts, TOPOLOGIES):
            results, launches = audit_cell(schedule, sync_mode, opt_name, topo_label, device)
            if compile_hlo:
                results += collective_checks(ranks[topo_label], topo_label, {
                    "schedule": schedule, "sync": sync_mode, "optimizer": opt_name,
                    "data_async": False})
            note(f"{schedule}/{sync_mode}/{opt_name}/{topo_label}", results)
            report["cells"].append({
                "schedule": schedule, "sync": sync_mode, "optimizer": opt_name,
                "topology": topo_label, "checks": [r.to_json() for r in results], **launches})

        for schedule, (precision, use_kernels) in itertools.product(SCHEDULES, PRECISION_CELLS):
            results, launches = audit_precision_cell(schedule, precision, use_kernels, device)
            kern = "kernels" if use_kernels else "plain"
            note(f"precision {schedule}/{precision}/{kern}", results)
            report["precision"].append({
                "schedule": schedule, "precision": precision, "use_kernels": use_kernels,
                "checks": [r.to_json() for r in results], **launches})

    data_async_cells()
    lint = check_repo_lint()
    note("ast_lint src/repro_torch", [lint])
    report["lint"] = lint.to_json()
    report["seconds"] = time.perf_counter() - t_start
    return report


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant checker for the engine matrix")
    p.add_argument("--matrix", default="smoke", help="grid to audit (smoke)")
    p.add_argument("--out", default=None, help="write the JSON report here")
    p.add_argument("--optimizers", default=None,
                   help="comma-separated subset of the optimizer axis (default: all)")
    p.add_argument("--no-hlo", action="store_true",
                   help="skip the checks the reference takes from compiled HLO: the "
                        "collective and donation checks, which run on gloo ranks "
                        "(one-process checks and lint only, faster)")
    p.add_argument("--lint-only", action="store_true",
                   help="run only the AST lint over src/repro_torch")
    p.add_argument("--data-async-only", action="store_true",
                   help="run only the async-data cells + lint (CI smoke)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the steps run: the card unless --device cpu "
                        "(raises when CUDA is asked for but absent)")
    # one rank of a topology's collective audit, started by run_ranks
    p.add_argument("--rank-worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--cells", default="[]", help=argparse.SUPPRESS)
    p.add_argument("--rank-out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.rank_worker:
        return rank_worker(args.rank_worker, args.cells, args.rank_out, args.device)
    if args.lint_only:
        from repro_torch.analysis.lint import check_repo_lint

        lint = check_repo_lint()
        report = {"matrix": None, "cells": [], "scaling": [],
                  "lint": lint.to_json(), "passed": lint.passed}
        print(f"ast_lint: {'PASS' if lint.passed else 'FAIL'} {lint.detail}")
    else:
        from repro_torch.launch.train import resolve_device

        device = resolve_device(args.device)
        opts = tuple(args.optimizers.split(",")) if args.optimizers else None
        report = run_matrix(args.matrix, optimizers=opts, compile_hlo=not args.no_hlo,
                            data_async_only=args.data_async_only, device=device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report -> {args.out}")
    n_checks = sum(len(c["checks"]) for c in report["cells"]) + \
        sum(len(s["checks"]) for s in report["scaling"]) + \
        sum(len(p["checks"]) for p in report.get("precision", [])) + \
        sum(len(d["checks"]) for d in report.get("data_async", [])) + 1
    print(f"analysis {'PASSED' if report['passed'] else 'FAILED'} ({n_checks} check runs)")
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
