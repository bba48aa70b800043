"""End-to-end driver: train a ~100M-parameter model for a few hundred steps
under simulated asynchronous pipeline parallelism with basis rotation,
checkpointing included. It wraps the port's launcher, ``python -m
repro_torch.launch.train``. Port of ``examples/train_async_pipeline.py``.

    PYTHONPATH=src python examples/train_async_pipeline_torch.py [--steps 300]

(paper_95m is the paper's own nanoGPT configuration: 32 blocks,
d_model=384, ~96M parameters; ``--quick`` runs its smoke config on 2
stages for 60 steps, unless ``--steps`` says otherwise.) It runs on the
card unless ``--device cpu``. ``--ckpt-dir`` and ``--out`` say where the
checkpoints and the metrics go.
"""
import argparse
import os
import subprocess
import sys
import tempfile
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def command(args) -> List[str]:
    """The launcher's command line for the parsed example arguments."""
    cmd = [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", "paper_95m",
        "--backend", args.backend,
        "--stages", "2" if args.quick else "8",  # the smoke config has 2 layers
        "--optimizer", "basis_rotation",
        "--rotation-source", "2nd", "--rotation-geometry", "bilateral",
        "--steps", str(args.steps or (60 if args.quick else 300)),
        "--batch", "4", "--seq", "128",
        "--ckpt-dir", args.ckpt_dir,
        "--out", args.out,
        "--device", args.device,
    ]
    if args.backend == "sim":
        cmd.append("--use-kernels")  # B4 and B5 on the card
    # always forwarded: an explicit --schedule with the sim backend surfaces
    # the launcher's own error instead of being silently ignored here
    cmd.extend(["--schedule", args.schedule])
    if args.quick:
        cmd.append("--smoke")
    return cmd


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None, help="default 300 (60 with --quick)")
    ap.add_argument("--quick", action="store_true",
                    help="reduced model (CI-sized), 60 steps")
    ap.add_argument("--backend", default="sim", choices=["sim", "spmd"],
                    help="sim: exact-delay simulation; spmd: the pipeline engine")
    ap.add_argument("--schedule", default="fill_drain", choices=["fill_drain", "1f1b"],
                    help="spmd tick schedule (1f1b: O(stages) activation stash)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt_95m"))
    ap.add_argument("--out", default=os.path.join("experiments", "train_95m_async_torch.json"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    cmd = command(args)
    print(" ".join(cmd), flush=True)
    src = os.path.join(ROOT, "src")
    env = {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.call(cmd, env=env)


if __name__ == "__main__":
    raise SystemExit(main())
