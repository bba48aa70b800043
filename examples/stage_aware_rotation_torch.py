"""Stage-aware basis rotation (paper Section 4.3 / Appendix I): allocate the
basis-refresh budget in proportion to each stage's delay and compare the
uniform, stage-aware and reversed allocations at the same total budget.
Port of ``examples/stage_aware_rotation.py``.

    PYTHONPATH=src python examples/stage_aware_rotation_torch.py [--quick] [--device cpu]

The same allocations run on the SPMD engine (per-stage periods over the
stacked leaves):

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --backend spmd \\
        --optimizer basis_rotation --stage-aware [--use-kernels]

It runs on the card unless ``--device cpu``; ``--quick`` takes 20 steps
instead of 200.
"""
import argparse
import os
import sys
from typing import Dict, List, Optional, Tuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs.base import (  # noqa: E402
    AttentionConfig,
    BlockSpec,
    ModelConfig,
    OptimizerConfig,
)

CFG = ModelConfig(
    num_layers=8, d_model=64, d_ff=256, vocab_size=128, max_seq_len=64,
    attention=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16),
    pattern=(BlockSpec("attn", "dense"),), norm="layernorm", mlp_act="gelu",
    learnable_pos_emb=True, scan_layers=False,
)
STAGES, STEPS, QUICK_STEPS = 8, 200, 20
ALLOCATIONS = (
    ("uniform", {}),
    ("stage-aware", {"stage_aware": True}),
    ("reversed (ablation)", {"stage_aware": True, "stage_aware_reversed": True}),
)


def delay_periods(params: Dict[str, torch.Tensor], base_freq: int = 10) -> List[Tuple[int, int]]:
    """The sorted distinct (delay, refresh period) pairs of the leaves of
    ``params`` (per-layer ``{path: tensor}``) under the stage-aware rule."""
    from repro_torch.core.stage_aware import freqs_for_delays
    from repro_torch.pipeline.partition import leaf_delays

    delays = leaf_delays(params, CFG, STAGES)
    return sorted(set(zip(delays, freqs_for_delays(delays, STAGES, base_freq))))


def train(allocation: Dict, params: Dict[str, torch.Tensor], steps: int, device) -> List[float]:
    """``steps`` simulated-async basis-rotation steps from ``params`` under
    one refresh allocation (``OptimizerConfig`` fields); returns the losses."""
    from repro_torch.data import batches
    from repro_torch.models import Transformer, param_leaves
    from repro_torch.optim.factory import build_optimizer
    from repro_torch.pipeline.simulate import run_sim_training

    model = Transformer(CFG, device=device, seed=None)
    with torch.no_grad():
        for k, p in param_leaves(model).items():
            p.copy_(params[k])
    ocfg = OptimizerConfig(name="basis_rotation", learning_rate=3e-3, total_steps=steps,
                           rotation_freq=10, **allocation)
    opt = build_optimizer(ocfg, param_leaves(model), CFG, num_stages=STAGES, use_kernels=True)
    _, _, losses = run_sim_training(model, opt, batches(CFG, 8, 32, seed=0, device=device),
                                    steps=steps)
    return losses


def main(argv: Optional[List[str]] = None) -> Dict[str, List[float]]:
    from repro_torch.core.stage_aware import NEVER
    from repro_torch.launch.train import resolve_device
    from repro_torch.models import init_model, param_leaves

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help=f"{QUICK_STEPS} steps, not {STEPS}")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    steps = args.steps or (QUICK_STEPS if args.quick else STEPS)
    params = {k: v.detach() for k, v in param_leaves(init_model(CFG, 0, device)).items()}
    print("delay -> refresh period (NEVER = no refresh):")
    for d, f in delay_periods(params):
        print(f"  tau={d}: every {'NEVER' if f >= NEVER else f} steps")
    results = {}
    for label, kw in ALLOCATIONS:
        losses = results[label] = train(kw, params, steps, device)
        tail = losses[-10:]
        print(f"{label:22s} final={sum(tail) / len(tail):.4f}")
    return results


if __name__ == "__main__":
    main()
