"""CLI: populate / inspect the kernel launch-plan cache.

    python -m repro_torch.tune --show
    python -m repro_torch.tune --measure                 # the main path's shapes
    python -m repro_torch.tune --adam paper_1b --adam 1024x1024
    python -m repro_torch.tune --flash 512x64 --dtype bfloat16 --matmul 384x1536x384
    python -m repro_torch.tune --cost-model              # no card needed

``--adam`` takes one leaf of R x C (a launch over R * C elements) or an
architecture id, which stands for the grouped launch over every rotated
leaf of its sim path's step. With no plan arguments it tunes the main
path's shapes: paper_95m's grouped B5 launch, B1-B3 at (256, 64) in
float32 and bf16 (6 heads) and at (256, 128) in float32 (16 heads,
qwen3_0_6b's), and B4 at every product of paper_95m's rotation groups.
Measured timing is the default on a card; with no card the CLI exits
unless ``--cost-model`` asks for the analytic backend. Each plan is
printed as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import torch

from repro_torch import tune

DEFAULT_ADAM = ("paper_95m",)
# (S, dh, dtype, heads): one attention call of paper_95m's and of qwen3_0_6b's path
DEFAULT_FLASH = ((256, 64, "float32", 6), (256, 64, "bfloat16", 6), (256, 128, "float32", 16))
DEFAULT_MATMUL_ARCH = "paper_95m"


def _dims(spec: str, n: int, flag: str) -> List[int]:
    parts = spec.lower().split("x")
    if len(parts) != n or not all(p.isdigit() for p in parts):
        raise SystemExit(f"{flag} wants {n} x-separated ints, got {spec!r}")
    return [int(p) for p in parts]


def _path(arch: str):
    """(the rotation products (m, n, k) of one sim step, its B5 leaves)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.bench_matmul import path_groups

    groups, leaves = path_groups(get_config(arch))
    products = sorted({(M, N, K) for group in groups for _, M, K, N, _, _ in group})
    return products, [tuple(s) for s in leaves]


def _adam(spec: str):
    """(elements, leaf shapes) of ``--adam RxC`` or ``--adam ARCH``."""
    if "x" in spec.lower():
        r, c = _dims(spec, 2, "--adam")
        return r * c, [(r, c)]
    _, leaves = _path(spec)
    return sum(int(torch.Size(s).numel()) for s in leaves), leaves


def _emit(kernel: str, shape, dtype: str, plan) -> None:
    print(json.dumps({"kernel": kernel, "shape": list(shape), "dtype": dtype,
                      "platform": tune.platform_name(), "plan": plan}), flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="Kernel launch-plan autotuner: populate/inspect the plan cache")
    ap.add_argument("--show", action="store_true", help="print the cache and exit")
    ap.add_argument("--cache", default=None, metavar="PATH",
                    help="cache file (default: $REPRO_TORCH_TUNE_CACHE or "
                         "~/.cache/repro_torch/tune.json)")
    ap.add_argument("--flash", action="append", default=[], metavar="SxDH",
                    help="B1-B3 at seq x head_dim")
    ap.add_argument("--matmul", action="append", default=[], metavar="MxNxK")
    ap.add_argument("--adam", action="append", default=[], metavar="RxC|ARCH",
                    help="B5's chunk for one R x C leaf or an architecture's grouped launch")
    ap.add_argument("--dtype", default="float32", help="of --flash (B4 and B5 take float32)")
    ap.add_argument("--measure", action="store_true",
                    help="force the measured backend (the default on a card)")
    ap.add_argument("--cost-model", action="store_true",
                    help="force the analytical backend, which needs no card")
    args = ap.parse_args(argv)

    if args.show:
        entries = tune.load_cache(args.cache)
        print(f"# {tune.cache_path(args.cache)} — {len(entries)} entries")
        for key in sorted(entries):
            print(f"{key}: {json.dumps(entries[key], sort_keys=True)}")
        return 0

    measured: Optional[bool] = None
    if args.measure:
        measured = True
    if args.cost_model:
        measured = False
    if measured is not False and not torch.cuda.is_available():
        raise SystemExit("python -m repro_torch.tune: no CUDA card here "
                         "(torch.cuda.is_available() is false), and only a card can time the "
                         "kernels; --cost-model runs the analytic backend instead")

    flash = [(*_dims(s, 2, "--flash"), args.dtype, 1) for s in args.flash]
    matmul = [tuple(_dims(s, 3, "--matmul")) for s in args.matmul]
    adam = list(args.adam)
    if not (flash or matmul or adam):
        flash, adam = list(DEFAULT_FLASH), list(DEFAULT_ADAM)
        matmul = _path(DEFAULT_MATMUL_ARCH)[0]

    for spec in adam:
        elements, leaves = _adam(spec)
        plan = tune.tune_adam_scale(elements, shapes=leaves, measured=measured, path=args.cache)
        _emit("adam_scale", (elements,), "float32", {**plan, "of": spec})
    for S, dh, dtype, heads in flash:
        plan = tune.tune_flash(S, dh, batch_heads=heads, dtype=dtype, measured=measured,
                               path=args.cache)
        _emit("flash", (S, dh), dtype, plan)
    for m, n, k in matmul:
        plan = tune.tune_matmul(m, n, k, measured=measured, path=args.cache)
        _emit("matmul", (m, n, k), "float32", plan)
    print(f"# cache -> {tune.cache_path(args.cache)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
