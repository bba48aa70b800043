"""B4, the grouped rotation matmul, on one training step's products of three
paths: paper_95m's sim path, qwen3_0_6b's SPMD path (4 stages, stacked
layers) and xlstm_1_3b's sim path cut to one superblock of 8 layers.

    PYTHONPATH=src python -m repro_torch.launch.bench_matmul
    PYTHONPATH=src python -m repro_torch.launch.bench_matmul --write-groups g.json
    cd OTHER_TREE && PYTHONPATH=src python /path/to/bench_matmul.py --groups g.json

For each path it prints one JSON object: per grouped launch the largest
absolute error against the plain version and the problems outside the
rotation parity tolerance (``tests/test_kernels.py:41``), and the device ms
of the step's four launches (each the median of 10 behind a sleep kernel).
``--write-groups`` writes the paths' problem lists and needs no card;
``--groups`` reads them instead of deriving them, so that a tree without
these configs (an older commit) runs the same problems: an A/B of two
kernels in one call on one card. Operands are random normal, A scaled by
1/sqrt(K).
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
from typing import Dict, List, Optional

import torch

RTOL, ATOL = 2e-3, 1e-4  # tests/test_kernels.py:41 rotation parity
SLEEP_CYCLES = 50_000_000  # longer than the host takes to enqueue the timed launches


def path_groups(cfg, stages: int = 0):
    """One step of a path's rotation products as the optimizer issues them:
    four grouped B4 launches (U^T [G, M], [G, M] V, U S, S V^T over every
    rotated leaf in leaf order), each a list of problems
    (batch, M, K, N, trans_a, trans_b), and the rotated leaves' shapes in
    leaf order, which one grouped B5 launch takes. With ``stages``, the SPMD
    path's stacked layout: one problem per rotated leaf kind, batched over
    all its layers."""
    from repro_torch.core.layout import build_layout
    from repro_torch.engine.spmd import opt_leaves, stack_stage_params
    from repro_torch.models import Transformer, param_leaves

    cfg = cfg.replace(scan_layers=False)
    leaves = param_leaves(Transformer(cfg, device="meta", seed=None))
    if stages:
        leaves = opt_leaves(*stack_stage_params(leaves, cfg, stages))
    plans = [p for p in build_layout(leaves, "bilateral") if p.rotate]
    dims = [(math.prod(p.shape[:-2]), *p.shape[-2:]) for p in plans]
    groups = [[(b, m, m, n, True, False) for b, m, n in dims] * 2,
              [(b, m, n, n, False, False) for b, m, n in dims] * 2,
              [(b, m, m, n, False, False) for b, m, n in dims],
              [(b, m, n, n, False, True) for b, m, n in dims]]
    return groups, [p.shape for p in plans]


def bench_paths() -> Dict[str, List[list]]:
    """The three paths' four groups each."""
    from repro_torch.configs import get_config

    return {"paper_95m_sim": path_groups(get_config("paper_95m"))[0],
            "qwen3_0_6b_spmd_4": path_groups(get_config("qwen3_0_6b"), 4)[0],
            "xlstm_1_3b_8_layers_sim": path_groups(
                get_config("xlstm_1_3b").replace(num_layers=8))[0]}


def _time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))


def bench_group(problems, gen: torch.Generator) -> Dict:
    from repro_torch.kernels import matmul as kmm

    ta, tb = problems[0][4:]
    As, Bs = [], []
    for b, M, K, N, _, _ in problems:
        As.append(torch.randn((b, K, M) if ta else (b, M, K), device="cuda", generator=gen)
                  / math.sqrt(K))
        Bs.append(torch.randn((b, N, K) if tb else (b, K, N), device="cuda", generator=gen))
    outs = kmm.matmul_grouped(As, Bs, trans_a=ta, trans_b=tb)
    wants = kmm.matmul_grouped_plain(As, Bs, trans_a=ta, trans_b=tb)
    row = {"problems": len(problems),
           "max_abs_err": max((o - w).abs().max().item() for o, w in zip(outs, wants)),
           "out_of_tolerance": sum(not torch.allclose(o, w, rtol=RTOL, atol=ATOL)
                                   for o, w in zip(outs, wants))}
    del outs, wants
    row["ms"] = _time_ms(lambda: kmm.matmul_grouped(As, Bs, trans_a=ta, trans_b=tb))
    return row


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", help="read the paths' problem lists from this JSON file")
    ap.add_argument("--write-groups", help="write the paths' problem lists here and stop")
    args = ap.parse_args(argv)
    if args.write_groups:
        with open(args.write_groups, "w") as f:
            json.dump(bench_paths(), f)
        return {}
    if not torch.cuda.is_available():
        raise SystemExit("bench_matmul measures the card: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.groups:
        with open(args.groups) as f:
            paths = json.load(f)
    else:
        paths = bench_paths()
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for path, groups in paths.items():
        rows = [bench_group(problems, gen) for problems in groups]
        torch.cuda.empty_cache()
        out[path] = {"ms": sum(r["ms"] for r in rows), "groups": rows}
        print(json.dumps({"path": path, "device": torch.cuda.get_device_name(0), **out[path]}),
              flush=True)
    return out


if __name__ == "__main__":
    main()
