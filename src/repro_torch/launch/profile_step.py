"""Where the time of a training step goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_step \\
        --arch paper_95m --stages 8 --use-kernels --batch 8 --seq 256 \\
        --warmup 2 --profile-steps 3
    PYTHONPATH=src python -m repro_torch.launch.profile_step \\
        --arch paper_95m --backend spmd --stages 8 --microbatches 8 \\
        --schedule 1f1b --use-kernels --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.profile_step \\
        --arch paper_95m --backend spmd --stages 8 --microbatches 8 \\
        --schedule 1f1b --use-kernels --batch 8 --seq 256 --precision bf16
    PYTHONPATH=src python -m repro_torch.launch.profile_step \
        --arch qwen3_0_6b --backend spmd --stages 4 --microbatches 8 \
        --schedule 1f1b --use-kernels --batch 8 --seq 256

Builds the trainer exactly as ``launch.train`` does (same flags, any
``--arch``, either backend, either SPMD schedule and, on the spmd backend,
``--precision bf16``), runs
``--warmup`` steps (step 0 refreshes every basis), samples the batches of
the next ``--profile-steps`` steps (timed apart), then traces those steps
with ``torch.profiler``. Prints one JSON line: the data time per step, the
traced wall time, the time the device was busy (the union of its kernel and
copy intervals) and its share of the wall time, the device time by kernel
group (each of this port's CUDA kernels, B1-B3's bf16 entry points apart,
cuBLAS products, QR, everything else), the
top kernels by device time and the top host operations by their own host
time. Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import torch

from repro_torch.launch import train

GROUPS = (  # first match wins; names are the kernels' symbol names
    ("port: matmul.cu", ("grouped_tf32x3_kernel<",)),
    ("port: adam_step.cu", ("adam_scale_grouped_kernel",)),
    # B1: flash_fwd.cu on float32 inputs, flash_fwd_bf16.cu on bf16
    ("port: flash_fwd.cu (B1)", ("flash_fwd_kernel", "flash_fwd_bf16_kernel")),
    # B2 and B3: flash_bwd.cu on float32 inputs, flash_bwd_bf16.cu on bf16
    ("port: flash_bwd dq (B2)", ("flash_bwd_dq_kernel", "flash_bwd_dq_bf16_kernel")),
    ("port: flash_bwd dkv (B3)", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_bf16_kernel")),
    ("qr", ("geqrf", "orgqr", "larf", "householder", "geqr2", "potrf", "trsm")),
    # cuBLAS's products: its bf16 ones run as nvjet kernels
    ("library gemm", ("gemm", "xmma", "cutlass", "sm90", "dot_kernel", "nvjet")),
)


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            bf16 = group.startswith("port: flash") and "bfloat16" in name
            return group + " bf16" if bf16 else group
    return "other"


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--profile-steps", type=int, default=3)
    ours, rest = ap.parse_known_args(argv)
    args = train.parse_args(rest)
    if args.device != "cuda":
        raise SystemExit("profile_step measures the card: it needs --device cuda")
    args.steps = max(args.steps, ours.warmup + ours.profile_steps)
    engine, data, _ = train.build(args)
    state = engine.init_state()
    t = 0
    for t in range(ours.warmup):
        state, _, _ = engine.step(state, next(data), t)
    engine.synchronize()

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    batches = [next(data) for _ in range(ours.profile_steps)]
    data_ms = 1e3 * (time.perf_counter() - t0) / ours.profile_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t, batch in enumerate(batches, start=ours.warmup):
            state, loss, _ = engine.step(state, batch, t)
        engine.synchronize()
        wall = time.perf_counter() - t0

    host = sorted(((e.key, e.self_cpu_time_total / 1e3) for e in prof.key_averages()),
                  key=lambda kv: -kv[1])[:15]
    # device activity only: kernels and copies, each counted once
    by_kernel: Dict[str, float] = {}
    spans = []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + (end - start) / 1e3
        spans.append((start, end))
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):  # union of the device intervals
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    groups: Dict[str, float] = {}
    for name, ms in by_kernel.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:25]
    result = {
        "phase": "profile", "steps": ours.profile_steps, "first_step": ours.warmup,
        "data_ms_per_step": data_ms, "wall_ms": 1e3 * wall, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e3 / (1e3 * wall),
        "groups_ms": groups, "top_kernels_ms": top, "top_host_ops_self_ms": host,
        "final_loss": float(loss),
        "device": torch.cuda.get_device_name(0), "backend": args.backend,
        "precision": args.precision,
        "schedule": args.schedule if args.backend == "spmd" else None,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
