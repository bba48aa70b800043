"""Quickstart: train a tiny decoder with Adam-with-Basis-Rotation under a
simulated 8-stage asynchronous pipeline, and compare it with vanilla async
Adam (PipeDream): the paper's core experiment in about a minute. Port of
``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py [--quick] [--device cpu]

It runs on the card unless ``--device cpu``; the rotation products and the
rotated Adam step run in the hand-written kernels there (B4, B5) and in
their plain versions on the CPU. ``--quick`` takes 20 steps instead of 200.
"""
import argparse
import os
import sys
from typing import Dict, List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs.base import (  # noqa: E402
    AttentionConfig,
    BlockSpec,
    ModelConfig,
    OptimizerConfig,
)

CFG = ModelConfig(
    name="quickstart_lm",
    num_layers=8, d_model=64, d_ff=256, vocab_size=128, max_seq_len=64,
    attention=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16),
    pattern=(BlockSpec("attn", "dense"),),
    norm="layernorm", mlp_act="gelu", learnable_pos_emb=True,
    scan_layers=False,  # per-layer params => exact per-stage delays
)
STAGES, STEPS, QUICK_STEPS = 8, 200, 20
LABELS = {"adam": "PipeDream (async Adam)", "basis_rotation": "Basis rotation"}


def initial_params(seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """The model's weights drawn from ``seed``, per layer (``{path: tensor}``)."""
    from repro_torch.models import init_model, param_leaves

    return {k: v.detach() for k, v in param_leaves(init_model(CFG, seed, device)).items()}


def train(name: str, params: Dict[str, torch.Tensor], steps: int, device,
          log_every: int = 0, total_steps: Optional[int] = None) -> List[float]:
    """``steps`` simulated-async steps of ``name`` (``adam`` or
    ``basis_rotation``) from ``params`` (any per-layer ``{path: tensor}``, e.g.
    the reference's weights through ``checkpoint/convert.py``) on the
    seeded synthetic stream, the learning-rate schedule spanning
    ``total_steps`` (default ``steps``); returns the losses."""
    from repro_torch.data import batches
    from repro_torch.models import Transformer, param_leaves
    from repro_torch.optim.factory import build_optimizer
    from repro_torch.pipeline.simulate import run_sim_training

    model = Transformer(CFG, device=device, seed=None)
    with torch.no_grad():
        for k, p in param_leaves(model).items():
            p.copy_(params[k])
    ocfg = OptimizerConfig(name=name, learning_rate=3e-3, total_steps=total_steps or steps,
                           rotation_freq=10)
    opt = build_optimizer(ocfg, param_leaves(model), CFG, num_stages=STAGES, use_kernels=True)
    _, _, losses = run_sim_training(model, opt, batches(CFG, 8, 32, seed=0, device=device),
                                    steps=steps, log_every=log_every)
    return losses


def main(argv: Optional[List[str]] = None) -> Dict[str, List[float]]:
    from repro_torch.launch.train import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help=f"{QUICK_STEPS} steps, not {STEPS}")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    steps = args.steps or (QUICK_STEPS if args.quick else STEPS)
    params = initial_params(0, device)
    print(f"model: {sum(p.numel() for p in params.values()):,} params, {STAGES} pipeline "
          f"stages (max gradient delay = {STAGES - 1})\n")
    results = {}
    for name, label in LABELS.items():
        print(f"--- {label} ---")
        results[label] = train(name, params, steps, device, log_every=max(steps // 5, 1))
    print("\nfinal losses (mean of last 10 steps):")
    for label, losses in results.items():
        tail = losses[-10:]
        print(f"  {label:26s} {sum(tail) / len(tail):.4f}")
    return results


if __name__ == "__main__":
    main()
