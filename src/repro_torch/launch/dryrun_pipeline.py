"""Dry run of the SPMD pipeline runtime: the paper's architecture, its layers
split over K stages, traced on the ``meta`` device for the ranks of the
port's own process grid. Port of ``repro/launch/dryrun_pipeline.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_pipeline \\
        [--multi-pod] [--stages 16] [--microbatches 32] \\
        [--schedule fill_drain|1f1b] [--stage-aware] [--use-kernels]

The reference compiles one program for the production meshes (stage 16,
data 16) and (pod 2, stage 16, data 16). The port runs that grid as one
process a position (``launch/topology.py``): each rank holds one stage's
slab of the stacked parameters, the shared leaves, their optimizer and
delay state, and trades activations and their gradients with the ranks of
the neighbouring stages (``engine/schedules.py``'s ``StageSlab``). This
traces, for the ranks of data shard 0, one per stage, the rank's step on
meta: the tick schedule's gradient over its slab (a transport that counts
what the rank sends in place of the wire), the clip, the
per-stage delayed update in place and its application. The defaults are
the reference's: 16 stages, 32 microbatches of 32 x pods sequences of 512
tokens (each rank takes its data shard's rows of every microbatch),
bfloat16 compute.

The row has the reference's keys (``kind: "pipeline_dryrun"``,
``schedule``, ``stage_aware``, ``status``, ``collectives``,
``argument_bytes``, ``temp_bytes``) for the rank with the largest peak, and
for every traced rank its argument bytes (parameters, optimizer and delay
state, batch), its peak, the bytes it sends a step across its slab's edges
and the bytes its data-axis reduction sums (the stage's gradients over its
data group, the loss and shared gradients over every rank), with the ring
all-reduce's traffic for them. ``--use-kernels`` runs the optimizer's
grouped kernel path, whose plain versions run on meta.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import OptimizerConfig, get_config
from repro_torch.engine.schedules import SCHEDULES, StageSlab, make_schedule_grad
from repro_torch.engine.spmd import opt_leaves, slab_optimizer
from repro_torch.launch.dryrun import StepTrace, tensor_bytes
from repro_torch.launch.roofline import ring_all_reduce_bytes
from repro_torch.launch.topology import Topology
from repro_torch.optim.base import apply_updates, clip_by_global_norm, global_norm

Tensor = torch.Tensor
SEQ = 512
DATA = 16
TRACE_STEP = 0


class CountingTransport:
    """The transport of one rank traced alone: what it would send is
    counted, and received buffers keep their shapes (on meta there is no
    data to receive)."""

    def __init__(self):
        self.bytes_sent = 0

    def exchange(self, sends: Sequence[Tuple[Tensor, int]],
                 recvs: Sequence[Tuple[Tensor, int]]) -> None:
        self.bytes_sent += _nbytes(x for x, _ in sends)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def trace_rank(cfg, ocfg: OptimizerConfig, topo: Topology, rank: int, microbatches: int,
               mb_rows: int, schedule: str, use_kernels: bool) -> Dict:
    """One rank's step of the pipeline on meta: its slab's argument bytes,
    peak, bytes sent across the slab's edges, and its reduction's bytes."""
    P, K = topo.num_devices, topo.stages
    slabs = [topo.process_slab(P, p) for p in range(P)]
    me = slabs[rank]
    (k0, k1), (lo, hi) = me.stages, me.data_shards

    def holder(stage: int) -> Optional[int]:
        return next((p for p, s in enumerate(slabs)
                     if s.stages[0] <= stage < s.stages[1] and s.data_shards == me.data_shards),
                    None)

    tr = CountingTransport()
    slab = StageSlab(k0, k1, holder(k0 - 1) if k0 > 0 else None,
                     holder(k1) if k1 < K else None, tr)
    grad_fn = make_schedule_grad(cfg, K, microbatches, schedule, slab=slab)
    opt, stacked, shared = slab_optimizer(cfg, ocfg, K, (k0, k1), use_kernels=use_kernels)
    params = opt_leaves(stacked, shared)
    state = opt.init(params)
    rows = mb_rows * (hi - lo)
    batch = {k: torch.zeros((microbatches, rows, SEQ), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}

    def step():
        loss, (gs, gsh) = grad_fn(stacked, shared, batch)
        grads = opt_leaves(gs, gsh)
        grads = clip_by_global_norm(grads, 1.0, norm=global_norm(grads))
        with torch.no_grad():
            updates, _ = opt.update(grads, state, params, TRACE_STEP, inplace=True)
            apply_updates(params, updates)
        return loss, gs, gsh

    held = [*params.values(), *(t for t in tree_leaves(state) if isinstance(t, Tensor)),
            *batch.values()]
    trace = StepTrace(held, count=False)
    t0 = time.time()
    with trace:
        loss, gs, gsh = step()
    data_group = sum(1 for s in slabs if s.stages == me.stages)
    stacked_sum = _nbytes(gs.values())
    world_sum = _nbytes(gsh.values()) + 4  # the shared gradients and the loss, float32
    return {"rank": rank, "stages": [k0, k1], "data_shards": [lo, hi],
            "argument_bytes": tensor_bytes(held), "temp_bytes": trace.peak,
            "peak_bytes": tensor_bytes(held) + trace.peak,
            "sent_bytes": tr.bytes_sent,
            "reduce_bytes": stacked_sum + world_sum,
            "reduce_ring_bytes": int(ring_all_reduce_bytes(stacked_sum, data_group)
                                     + ring_all_reduce_bytes(world_sum, P)),
            "trace_s": round(time.time() - t0, 2)}


def dryrun_pipeline(arch: str = "paper_95m", stages: int = 16, microbatches: int = 32,
                    schedule: str = "fill_drain", stage_aware: bool = False,
                    use_kernels: bool = False, multi_pod: bool = False) -> Dict:
    K, M = stages, microbatches
    cfg = get_config(arch).replace(scan_layers=False, dtype="bfloat16")
    if cfg.num_layers % K:
        raise ValueError(f"{K} stages do not divide {cfg.num_layers} layers")
    topo = (Topology(stages=K, data=DATA, pods=2) if multi_pod
            else Topology(stages=K, data=DATA))
    mb = 32 * topo.pods  # per-microbatch global batch scales with the pods
    mb_rows = mb // topo.data_shards
    ocfg = OptimizerConfig(name="basis_rotation", learning_rate=1e-3, total_steps=10_000,
                           rotation_freq=10, stage_aware=stage_aware)
    P = topo.num_devices
    ranks = [p for p in range(P) if topo.process_slab(P, p).data_shards[0] == 0]
    t0 = time.time()
    per_rank = [trace_rank(cfg, ocfg, topo, r, M, mb_rows, schedule, use_kernels)
                for r in ranks]
    top = max(per_rank, key=lambda r: r["peak_bytes"])
    return {
        "kind": "pipeline_dryrun",
        "arch": arch,
        "mesh": topo.describe(),
        "stages": K,
        "microbatches": M,
        "schedule": schedule,
        "stage_aware": stage_aware,
        "use_kernels": use_kernels,
        "status": "ok",
        "compile_s": round(time.time() - t0, 1),
        "processes": P,
        "seq": SEQ,
        "microbatch_rows": mb_rows,
        "collectives": {"all-reduce": top["reduce_ring_bytes"],
                        "send": max(r["sent_bytes"] for r in per_rank)},
        "argument_bytes": top["argument_bytes"],
        "temp_bytes": top["temp_bytes"],
        "peak_bytes": top["peak_bytes"],
        "peak_rank": top["rank"],
        "sent_bytes": max(r["sent_bytes"] for r in per_rank),
        "reduce_bytes": top["reduce_bytes"],
        "ranks": per_rank,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--stages", type=int, default=16)
    ap.add_argument("--microbatches", type=int, default=32)
    ap.add_argument("--schedule", default="fill_drain", choices=SCHEDULES)
    ap.add_argument("--stage-aware", action="store_true",
                    help="per-stage basis-refresh periods over the stacked leaves")
    ap.add_argument("--use-kernels", action="store_true",
                    help="the optimizer's grouped kernel path (plain versions on meta)")
    ap.add_argument("--arch", default="paper_95m")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    row = dryrun_pipeline(args.arch, args.stages, args.microbatches, args.schedule,
                          args.stage_aware, args.use_kernels, args.multi_pod)
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    return row


if __name__ == "__main__":
    main()
