"""End-to-end training entry point. Port of ``repro/launch/train.py``.

``--backend sim`` (the default) is the single-program simulation of K-stage
asynchronous pipeline parallelism, the paper's experimental setup:
staleness is imposed exactly by the per-leaf gradient FIFO. ``--backend
spmd`` is the physical pipeline (``engine.spmd``): stage-stacked weights,
the ``--schedule`` fill-drain or 1F1B tick schedule over ``--microbatches``
microbatches (default: one per stage), and the per-stage delay FIFO
(``--sync`` drops it). With ``--use-kernels`` every rotation product and
rotated Adam step runs in the hand-written CUDA kernels (``kernels/csrc``),
and on the spmd backend attention runs in the flash-attention kernels too.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch paper_95m --stages 8 --optimizer basis_rotation \\
        --steps 300 --batch 8 --seq 256 --lr 1e-3 --use-kernels
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch paper_95m --backend spmd --stages 8 --microbatches 8 \\
        --schedule 1f1b --optimizer basis_rotation --use-kernels --batch 8 --seq 256

``--arch`` takes the paper's models, the dense public architectures
(``qwen3_0_6b``, ``qwen1_5_0_5b``, ``stablelm_1_6b``, ``phi4_mini_3_8b``,
``phi4_mini_3_8b_swa``) and ``xlstm_1_3b``; a full config's depth must
divide into ``--stages``. A pattern of mixed block kinds (xLSTM's mLSTM and
sLSTM blocks) runs on the sim backend only: the reference's SPMD runtime
stacks homogeneous layers, and ``--backend spmd`` refuses it before any
work. ``--precision`` applies its policy over the config's own
dtypes, so the default ``f32`` trains the catalog's bfloat16 configs in
float32, as the reference's launcher does.

On the sim backend ``--weight-prediction`` (PipeMare) and ``--no-stash``
select the other staleness modes. ``--precision bf16`` (the
``bf16_compute`` policy: bfloat16 activations and products, float32
masters, optimizer state and loss) is an spmd-backend policy, as in the
reference; with ``--use-kernels`` attention then runs in the flash
kernels' bfloat16 entry points. ``--ckpt-dir D --ckpt-every N``
checkpoints every N steps and at the end, in the reference's format; a
rerun with the same directory resumes from its checkpoint, fast-forwarding
the data stream past the batches already consumed.

It runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for but absent. The reference's flags are accepted; those whose
feature is not ported yet exit with a message that says so.
"""
from __future__ import annotations

import argparse
import math
from typing import Dict, List, Optional

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_95m")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--backend", default="sim", choices=["sim", "spmd"])
    ap.add_argument("--stages", type=int, default=8)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--data-par", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--schedule", default="fill_drain", choices=["fill_drain", "1f1b"])
    ap.add_argument("--optimizer", default="basis_rotation")
    ap.add_argument("--rotation-source", default="2nd", choices=["1st", "2nd"])
    ap.add_argument("--rotation-geometry", default="bilateral",
                    choices=["unilateral", "bilateral"])
    ap.add_argument("--rotation-freq", type=int, default=10)
    ap.add_argument("--stage-aware", action="store_true")
    ap.add_argument("--use-kernels", action="store_true",
                    help="route the optimizer's rotation products and fused "
                         "Adam scale (and, on the spmd backend, attention) "
                         "through the CUDA kernels (their plain PyTorch "
                         "versions on --device cpu)")
    ap.add_argument("--precision", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--weight-prediction", action="store_true")
    ap.add_argument("--no-stash", action="store_true")
    ap.add_argument("--sync", action="store_true",
                    help="synchronous gradients: no delay FIFO")
    ap.add_argument("--data-async", action="store_true")
    ap.add_argument("--data-delay", type=int, default=None)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--out", default=None, help="write the loss curve as JSON")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=0)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def _refuse_unported(args) -> None:
    unported = {
        "--data-async / --data-delay": args.data_async or args.data_delay is not None,
        "--coordinator / --num-processes / --process-id":
            args.coordinator is not None or args.num_processes > 1 or args.process_id != 0,
    }
    if args.backend == "spmd":
        unported["--pods / --data-par (the spmd data axis)"] = args.pods != 1 or args.data_par > 1
    for flag, used in unported.items():
        if used:
            raise SystemExit(f"{flag} is not yet ported to repro_torch")
    if args.backend == "spmd":
        if args.weight_prediction or args.no_stash:
            raise SystemExit(
                "--weight-prediction / --no-stash are sim-backend modes; the spmd "
                "backend imposes weight-stashing staleness physically"
            )
        return
    if args.precision != "f32":
        raise SystemExit(
            "--precision bf16 is an spmd-backend policy; the sim backend "
            "reproduces the paper's f32 runs bit-for-bit"
        )
    if args.schedule != "fill_drain":
        raise SystemExit(
            "--schedule picks the SPMD tick schedule; the sim backend imposes "
            "delays directly and has no schedule"
        )
    if args.pods != 1 or args.data_par > 1 or args.microbatches:
        raise SystemExit(
            "--pods / --data-par / --microbatches describe the spmd topology; "
            "the sim backend is a single-program simulation"
        )


def resolve_device(name: str) -> torch.device:
    """The device to run on; CUDA unless the caller asks for the CPU."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
        # the reference's sim path is exact float32: no TF32 anywhere; and its
        # bfloat16 products accumulate in float32, so cuBLAS's must too
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def build(args):
    """The trainer that ``args`` describe: (engine, data iterator, loop config)."""
    _refuse_unported(args)
    device = resolve_device(args.device)

    from repro_torch.configs import PRECISION_POLICIES, OptimizerConfig, get_config
    from repro_torch.data import batches
    from repro_torch.engine import LoopConfig, SimEngine, SpmdEngine
    from repro_torch.models import Transformer, init_model, param_count, param_leaves
    from repro_torch.models.transformer import check_homogeneous
    from repro_torch.optim.base import make_schedule
    from repro_torch.optim.factory import build_optimizer
    from repro_torch.pipeline.partition import delay_tree

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.backend == "spmd":
        try:
            check_homogeneous(cfg)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    # the precision policy owns every dtype knob; the spmd engine applies it
    cfg = cfg.replace(scan_layers=False)
    policy = PRECISION_POLICIES[args.precision]
    if cfg.num_layers % args.stages != 0:
        if args.smoke:
            # pad the reduced config up to the nearest depth that both the
            # pattern and the stage count divide
            layers = math.lcm(len(cfg.pattern), args.stages)
            while layers < cfg.num_layers:
                layers += math.lcm(len(cfg.pattern), args.stages)
            print(f"smoke: padding {cfg.num_layers} layers -> {layers} "
                  f"to divide {args.stages} stages")
            cfg = cfg.replace(num_layers=layers)
        else:
            raise SystemExit(f"--stages {args.stages} must divide {cfg.num_layers} layers")

    ocfg = OptimizerConfig(
        name=args.optimizer, learning_rate=args.lr, total_steps=args.steps,
        rotation_source=args.rotation_source,
        rotation_geometry=args.rotation_geometry,
        rotation_freq=args.rotation_freq, stage_aware=args.stage_aware,
    )
    if args.backend == "spmd":
        M = args.microbatches or args.stages
        if args.batch % M:
            raise SystemExit(f"--batch {args.batch} must split into {M} microbatches")
        # the engine draws the model from the seed itself, into its stacked layout
        engine = SpmdEngine(cfg, ocfg, num_stages=args.stages, num_microbatches=M,
                            schedule=args.schedule, async_grads=not args.sync,
                            use_kernels=args.use_kernels, grad_clip=1.0, device=device,
                            seed=args.seed, precision=policy)
        n_params = param_count(Transformer(engine.cfg, device="meta", seed=None))
    else:
        cfg = policy.apply(cfg)
        model = init_model(cfg, seed=args.seed, device=device)
        params = param_leaves(model)
        opt = build_optimizer(ocfg, params, cfg, num_stages=args.stages,
                              apply_delay=not args.sync, use_kernels=args.use_kernels)
        sched = make_schedule(ocfg.schedule, ocfg.learning_rate, ocfg.total_steps,
                              ocfg.warmup_frac)
        engine = SimEngine(model, opt, grad_clip=1.0,
                           weight_prediction=args.weight_prediction,
                           delays_tree=delay_tree(params, cfg, args.stages),
                           schedule=sched, no_stash=args.no_stash)
        n_params = param_count(model)
    print(f"arch={cfg.name} params={n_params:,} stages={args.stages} "
          f"optimizer={args.optimizer} backend={args.backend} precision={policy.name} "
          f"device={device}")
    data = batches(cfg, args.batch, args.seq, seed=args.seed, device=device)
    loop_cfg = LoopConfig(
        steps=args.steps, log_every=args.log_every,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, out_path=args.out,
        out_meta={"arch": cfg.name, "optimizer": args.optimizer,
                  "stages": args.stages, "backend": args.backend,
                  "schedule": args.schedule if args.backend == "spmd" else None,
                  "precision": args.precision, "use_kernels": args.use_kernels,
                  "device": str(device)},
    )
    return engine, data, loop_cfg


def main(argv: Optional[List[str]] = None) -> Dict:
    """Train; returns the losses (of the steps this run took), the step it
    started from, and the per-step data and step times and the checkpoint
    snapshot and write times."""
    from repro_torch.engine import resume_if_present, run_loop

    args = parse_args(argv)
    engine, data, loop_cfg = build(args)
    # resume_if_present fast-forwards `data` past the consumed batches, so
    # that a resumed run continues the uninterrupted stream
    state, start_step = resume_if_present(engine, None, args.ckpt_dir, data)
    if start_step:
        print(f"resumed from {args.ckpt_dir} at step {start_step}", flush=True)
    # run_loop builds the initial state itself when there is none, and is
    # handed the resumed one as its only holder, so that nothing here keeps
    # the first state (and its optimizer state) alive for the whole run
    held = [state]
    del state
    _, losses, timings = run_loop(engine, data, loop_cfg, state=held.pop(),
                                  start_step=start_step)
    if losses:
        print(f"final loss {losses[-1]:.4f}")
    return {"losses": losses, "start_step": start_step, "data_s": timings.data_s,
            "step_s": timings.step_s, "ckpt_s": timings.ckpt_s, "write_s": timings.write_s,
            "tokens_per_step": args.batch * args.seq}


if __name__ == "__main__":
    main()
