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

On the spmd backend the run may span several processes, each running its
slab of the (pod, stage, data) grid (``Topology.process_slab``):
``--num-processes N --process-id I --coordinator HOST:PORT``, or the
``REPRO_*`` environment that ``launch/spawn.py`` sets
(``launch.distributed``). Rank I computes on ``cuda:(I % device_count)``
(or the CPU under ``--device cpu``) and talks to the others over NCCL with
a card per rank, gloo otherwise (``launch.devices``; ``--transport nccl``
is refused where ranks share a card). Each process feeds only its
data shards' rows (``data.process_local_batches``); logging and ``--out``
belong to process 0, and every process writes its own checkpoint shards.
``--rank-stats DIR`` writes each process's launches, step and data times,
peak memory and bytes sent to ``DIR/rank<I>.json``.

It runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for but absent. The reference's flags are accepted. On the sim
backend ``--microbatches`` and ``--process-id`` are ignored, as the
reference ignores them there, and the other multi-process flags are refused
in the reference's words.
"""
from __future__ import annotations

import argparse
import math
import time
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
    ap.add_argument("--transport", default="auto", choices=["auto", "nccl"],
                    help="auto: the layout's transport (launch.devices); nccl: the same, "
                         "refused unless every rank has a card of its own")
    ap.add_argument("--rank-stats", default=None,
                    help="directory for each process's rank<I>.json of launches, "
                         "times, peak memory and bytes sent")
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


def resolve_device(name: str, process_index: Optional[int] = None) -> torch.device:
    """The device to run on; CUDA unless the caller asks for the CPU. A rank
    of a multi-process run (``process_index``) takes
    ``devices.rank_device``'s card."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
        # the reference's sim path is exact float32: no TF32 anywhere; and its
        # bfloat16 products accumulate in float32, so cuBLAS's must too
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        if process_index is not None:
            from repro_torch.launch.devices import rank_device

            torch.cuda.set_device(rank_device(name, process_index))
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def resolve_grid(args):
    """The reference's process grid of an spmd run: from ``--num-processes``
    / ``--process-id`` / ``--coordinator`` when ``--num-processes`` is
    given, else from the ``REPRO_*`` environment, else one process."""
    from repro_torch.launch.distributed import ProcessGrid, distributed_env

    if args.backend != "spmd":
        return ProcessGrid()
    if args.num_processes:
        return ProcessGrid(num_processes=args.num_processes, process_index=args.process_id,
                           coordinator=args.coordinator)
    return distributed_env() or ProcessGrid()


def build(args):
    """The trainer that ``args`` describe: (engine, data iterator, loop config)."""
    from repro_torch.configs import PRECISION_POLICIES, OptimizerConfig, get_config

    data_delay = data_delay_of(args)
    cfg = get_config(args.arch, smoke=args.smoke)
    _refuse_unported(args, cfg)
    grid = resolve_grid(args)
    n_dev = args.pods * args.stages * max(args.data_par, 1)  # positions of the grid
    if n_dev % grid.num_processes:
        raise SystemExit(
            f"{grid.num_processes} processes do not split the "
            f"{n_dev}-device (pods={args.pods}, stages={args.stages}, "
            f"data={args.data_par}) topology evenly"
        )
    device = resolve_device(args.device, grid.process_index if grid.distributed else None)
    from repro_torch.launch.distributed import init_distributed, is_main

    # join the process group before the engine is built: it reads its slab
    init_distributed(grid, device, args.transport)
    main_proc = is_main()

    from repro_torch.data import batches, process_local_batches
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
            if main_proc:
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
        # every process runs an equal slab of the grid; --data-par 0 (fill
        # the data axis from the devices) means one replica a pod
        topology = Topology.from_process_grid(args.stages, grid.num_processes,
                                              n_dev // grid.num_processes, pods=args.pods,
                                              data=args.data_par)
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
    if main_proc:
        print(f"arch={cfg.name} params={n_params:,} stages={args.stages} "
              f"optimizer={args.optimizer} backend={args.backend} precision={policy.name} "
              f"device={device}" + (f" topology={topo_str}" if topo_str else "")
              + (f" {grid.describe()}" if grid.distributed else ""))
    if grid.distributed:
        # each process takes its data shards' rows of every microbatch;
        # stacked over the processes they are the single-process stream
        lo, hi = topology.process_data_shards(grid.num_processes, grid.process_index)
        data = process_local_batches(cfg, args.batch, args.seq, num_microbatches=M,
                                     data_shards=topology.data_shards, shard_lo=lo,
                                     shard_hi=hi, seed=args.seed, device=device)
    else:
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
                  "device": str(device), "num_processes": grid.num_processes},
    )
    return engine, data, loop_cfg


def kernel_launches() -> Dict[str, int]:
    """Every kernel wrapper's launch count in this process (B1-B3 by entry
    point, float32 and bf16)."""
    from repro_torch.kernels import adam_step, flash, matmul

    fns = {"flash_fwd": flash.flash_fwd, "flash_bwd_dq": flash.flash_bwd_dq,
           "flash_bwd_dkv": flash.flash_bwd_dkv, "matmul": matmul.matmul,
           "adam_scale": adam_step.adam_scale}
    out = {}
    for name, fn in fns.items():
        out[name] = getattr(fn, "launches", 0)
        if name.startswith("flash"):
            out[name + "_bf16"] = getattr(fn, "launches_bf16", 0)
    return out


def write_rank_stats(path: str, engine, result: Dict, launches: Dict[str, int]) -> None:
    """This process's ``rank<I>.json`` under ``path``: its slab, the kernel
    launches of this run, the seconds to build (and resume) the trainer,
    step and data times, peak device memory, bytes it sent, and how long
    its barriers waited."""
    import json
    import os

    from repro_torch.launch.distributed import barrier_waits, process_index

    tr = getattr(engine, "transport", None)
    slab = getattr(engine, "slab", None)
    dev = engine.device
    stats = {"rank": process_index(), "device": str(dev),
             "stages": list(slab.stages) if slab else None,
             "data_shards": list(slab.data_shards) if slab else None,
             "transport": None if tr is None else {"backend": tr.backend, "staged": tr.staged},
             "launches": launches, "steps": len(result["losses"]),
             "start_step": result["start_step"], "setup_s": result["setup_s"],
             "step_s": result["step_s"],
             "data_s": result["data_s"], "ckpt_s": result["ckpt_s"],
             "write_s": result["write_s"], "bytes_sent": None if tr is None else tr.bytes_sent,
             "barrier_s": barrier_waits(),
             "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else None)}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, f"rank{stats['rank']}.json"), "w") as f:
        json.dump(stats, f)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Train; returns the losses (of the steps this run took), the step it
    started from, and the per-step data and step times and the checkpoint
    snapshot and write times."""
    from repro_torch.launch.distributed import shutdown

    args = parse_args(argv)
    try:
        return _train(args)
    finally:
        shutdown()  # leave the process group, if this run joined one


def _train(args) -> Dict:
    from repro_torch.engine import resume_if_present, run_loop
    from repro_torch.launch.distributed import is_main

    t0 = time.perf_counter()
    launches0 = kernel_launches() if args.rank_stats else None
    engine, data, loop_cfg = build(args)
    main_proc = is_main()
    # resume_if_present fast-forwards `data` past the consumed batches, so
    # that a resumed run continues the uninterrupted stream
    state, start_step = resume_if_present(engine, None, args.ckpt_dir, data)
    if start_step and main_proc:
        print(f"resumed from {args.ckpt_dir} at step {start_step}", flush=True)
    # run_loop builds the initial state itself when there is none, and is
    # handed the resumed one as its only holder, so that nothing here keeps
    # the first state (and its optimizer state) alive for the whole run
    held = [state]
    del state
    setup_s = time.perf_counter() - t0  # the trainer built, resumed and fast-forwarded
    _, losses, timings = run_loop(engine, data, loop_cfg, state=held.pop(),
                                  start_step=start_step)
    if losses and main_proc:
        print(f"final loss {losses[-1]:.4f}")
    result = {"losses": losses, "start_step": start_step, "data_s": timings.data_s,
              "step_s": timings.step_s, "ckpt_s": timings.ckpt_s, "write_s": timings.write_s,
              "setup_s": setup_s, "tokens_per_step": args.batch * args.seq}
    if args.rank_stats:
        now = kernel_launches()
        write_rank_stats(args.rank_stats, engine, result,
                         {k: now[k] - launches0[k] for k in now})
    return result


if __name__ == "__main__":
    main()
