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
``phi4_mini_3_8b_swa``), ``xlstm_1_3b``, the frontends (``llava_next_34b``:
a projected vision prefix; ``musicgen_large``: four codebooks), the MoE
``mixtral_8x22b``, the Mamba hybrid ``jamba_v0_1_52b`` and the MLA and MoE
``deepseek_v2_236b``; a full config's depth must divide into ``--stages``. A
pattern of mixed block kinds (xLSTM's mLSTM and sLSTM blocks, jamba's Mamba
and attention blocks) runs on the sim backend only: the reference's SPMD
runtime stacks homogeneous layers, and ``--backend spmd`` refuses it before
any work. So does it refuse the
frontend configs, on which the reference's SPMD engine is wrong, and the
sim backend refuses ``--no-stash`` with a frontend prefix, which the
reference's two-version loss drops (see ``_refuse_unported``).
``--precision`` applies its policy over the config's own dtypes, so the
default ``f32`` trains the catalog's bfloat16 configs in float32, as the
reference's launcher does.

On the sim backend ``--weight-prediction`` (PipeMare) and ``--no-stash``
select the other staleness modes. ``--precision bf16`` (the
``bf16_compute`` policy: bfloat16 activations and products, float32
masters, optimizer state and loss) is an spmd-backend policy, as in the
reference; with ``--use-kernels`` attention then runs in the flash
kernels' bfloat16 entry points. ``--ckpt-dir D --ckpt-every N``
checkpoints every N steps and at the end, in the reference's format; a
rerun with the same directory resumes from its checkpoint, fast-forwarding
the data stream past the batches already consumed.

``--data-async [--data-delay D]`` (D defaults to 1) makes the data axis
asynchronous. On the sim backend it adds D steps of uniform staleness to
every leaf's gradient FIFO (one replica's reduction is the identity, so a
D-step-late gradient is the deferred reduction). On the spmd backend
``--pods P --data-par R`` place the run on a (pod, stage, data)
``Topology`` whose P * R data replicas run in this one process, each on its
rows of every microbatch, and ``--data-async`` applies their mean gradient
D steps late (``--data-par 0``, the default, means one replica per pod).
``--data-delay 0`` is the synchronous data axis, bit for bit.

It runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for but absent. The reference's flags are accepted; those whose
feature is not ported yet (the multi-process flags on the spmd backend)
exit with a message that says so. On the sim backend ``--microbatches``
and ``--process-id`` are ignored, as the reference ignores them there.
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


# optimizers whose state the sim backend's --weight-prediction cannot read,
# as in the reference (see _refuse_unported)
WEIGHT_PREDICTION_REFUSED = ("adasgd",)


def data_delay_of(args) -> int:
    """The reference's checks of the data-axis flags; the data delay D (1 by
    default under ``--data-async``, 0 without it)."""
    if args.data_delay is not None and not args.data_async:
        raise SystemExit("--data-delay only applies under --data-async")
    if args.data_async and args.sync:
        raise SystemExit(
            "--sync forces fully synchronous gradients; it cannot be "
            "combined with --data-async"
        )
    data_delay = (1 if args.data_delay is None else args.data_delay) if args.data_async else 0
    if data_delay < 0:
        raise SystemExit("--data-delay must be >= 0")
    return data_delay


def _refuse_unported(args, cfg) -> None:
    """Exit, naming why, on what the port does not run: what the reference
    refuses or gets wrong, and what is not ported yet."""
    if args.backend == "spmd":
        if args.coordinator is not None or args.num_processes > 1 or args.process_id != 0:
            raise SystemExit(
                "--coordinator / --num-processes / --process-id is not yet ported to repro_torch")
        if args.weight_prediction or args.no_stash:
            raise SystemExit(
                "--weight-prediction / --no-stash are sim-backend modes; the spmd "
                "backend imposes weight-stashing staleness physically"
            )
        from repro_torch.engine.spmd import check_spmd_config

        try:
            check_spmd_config(cfg)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        return
    # the sim backend refuses what the reference's does (repro/launch/train.py
    # main) and, like it, ignores --microbatches and --process-id
    if args.precision != "f32":
        raise SystemExit(
            "--precision bf16 is an spmd-backend policy; the sim backend "
            "reproduces the paper's f32 runs bit-for-bit"
        )
    if args.schedule != "fill_drain":
        raise SystemExit(
            "--schedule picks the SPMD tick schedule; the sim backend imposes "
            "delays directly and has no schedule (use --backend spmd)"
        )
    if args.pods != 1 or args.data_par > 1:
        raise SystemExit(
            "--pods / --data-par describe the spmd device topology; the sim "
            "backend is a single-program simulation (use --backend spmd)"
        )
    if args.num_processes > 1 or args.coordinator:
        raise SystemExit(
            "--coordinator / --num-processes are spmd-backend options; the "
            "sim backend is a single-program simulation (use --backend spmd)"
        )
    # --weight-prediction reads Adam-style moments: the reference's
    # predict_weights (repro/pipeline/simulate.py:49-79) fails on this command
    # line for adasgd, whose second moment is one scalar (jax.tree.map over
    # params and v: "ValueError: Expected dict"). Of the baselines, only
    # adasgd: nesterov, nesterov_pp, pipedream_lr, delay_compensation, muon
    # and scion run there in both packages (--smoke --stages 2 --steps 2)
    if args.weight_prediction and args.optimizer in WEIGHT_PREDICTION_REFUSED:
        raise SystemExit(
            f"--weight-prediction with --optimizer {args.optimizer} is not supported: "
            "the reference's predict_weights (repro/pipeline/simulate.py:49-79) "
            "fails on it (its second moment is a scalar, not a tree of leaves)"
        )
    # the reference's two-version loss embeds batch["tokens"] alone
    # (repro/pipeline/simulate.py:126-135): the frontend prefix is dropped
    if args.no_stash and cfg.frontend is not None and cfg.frontend_tokens:
        raise SystemExit(
            f"--no-stash with {cfg.name}'s {cfg.frontend} frontend prefix is not supported: "
            "the reference's two-version loss (repro/pipeline/simulate.py:126-135) "
            "silently drops the prefix"
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
    from repro_torch.configs import PRECISION_POLICIES, OptimizerConfig, get_config

    data_delay = data_delay_of(args)
    cfg = get_config(args.arch, smoke=args.smoke)
    _refuse_unported(args, cfg)
    device = resolve_device(args.device)

    from repro_torch.data import batches
    from repro_torch.engine import LoopConfig, SimEngine, SpmdEngine
    from repro_torch.launch.topology import Topology
    from repro_torch.models import Transformer, init_model, param_count, param_leaves
    from repro_torch.optim.base import make_schedule
    from repro_torch.optim.factory import build_optimizer
    from repro_torch.pipeline.partition import delay_tree

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
    topology = None
    if args.backend == "spmd":
        # one card holds every (pod, stage, data) position, so --data-par 0
        # (fill the data axis from the devices) means one replica a pod
        topology = Topology(stages=args.stages, data=max(args.data_par, 1), pods=args.pods)
        M = args.microbatches or args.stages
        shards = topology.data_shards
        if args.batch % M or (args.batch // M) % shards:
            raise SystemExit(
                f"--batch {args.batch} must split into {M} microbatches of a "
                f"size divisible by the {shards} data shard(s) of topology "
                f"{topology.describe()}"
            )
        # the engine draws the model from the seed itself, into its stacked layout
        engine = SpmdEngine(cfg, ocfg, num_stages=args.stages, num_microbatches=M,
                            schedule=args.schedule, async_grads=not args.sync,
                            use_kernels=args.use_kernels, grad_clip=1.0, device=device,
                            seed=args.seed, precision=policy, topology=topology,
                            data_async=args.data_async, data_delay=data_delay)
        n_params = param_count(Transformer(engine.cfg, device="meta", seed=None))
    else:
        cfg = policy.apply(cfg)
        model = init_model(cfg, seed=args.seed, device=device)
        params = param_leaves(model)
        # --data-async deepens every leaf's FIFO by D; the engine's delays
        # (weight prediction, no-stash) stay the pipeline's, as in the reference
        opt = build_optimizer(ocfg, params, cfg, num_stages=args.stages,
                              apply_delay=not args.sync, use_kernels=args.use_kernels,
                              data_delay=data_delay)
        sched = make_schedule(ocfg.schedule, ocfg.learning_rate, ocfg.total_steps,
                              ocfg.warmup_frac)
        engine = SimEngine(model, opt, grad_clip=1.0,
                           weight_prediction=args.weight_prediction,
                           delays_tree=delay_tree(params, cfg, args.stages),
                           schedule=sched, no_stash=args.no_stash)
        n_params = param_count(model)
    topo_str = topology.describe() if topology is not None else None
    print(f"arch={cfg.name} params={n_params:,} stages={args.stages} "
          f"optimizer={args.optimizer} backend={args.backend} precision={policy.name} "
          f"device={device}" + (f" topology={topo_str}" if topo_str else ""))
    # one process samples the global stream whatever the pods: the
    # reference's per-host assembly of it gives the same bits
    data = batches(cfg, args.batch, args.seq, seed=args.seed, device=device)
    loop_cfg = LoopConfig(
        steps=args.steps, log_every=args.log_every,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, out_path=args.out,
        out_meta={"arch": cfg.name, "optimizer": args.optimizer,
                  "stages": args.stages, "backend": args.backend,
                  "schedule": args.schedule if args.backend == "spmd" else None,
                  "topology": topo_str, "precision": args.precision,
                  "use_kernels": args.use_kernels,
                  "data_async": args.data_async, "data_delay": data_delay,
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
