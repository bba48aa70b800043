"""Single-machine multi-process launcher. Port of ``repro/launch/spawn.py``.

Starts N real OS processes, each running ``python -m
repro_torch.launch.train`` under the ``REPRO_*`` environment contract
(``repro_torch.launch.distributed``), with a fresh coordinator port on
127.0.0.1. This is the path a cluster scheduler takes across machines, one
process per slab of the grid, shrunk to one machine: on the CPU
(``--device cpu`` in the train arguments) the ranks talk over gloo; on one
card they share it, over gloo with host-staged transfers; with a card per
rank, over NCCL (``launch.devices``).

    PYTHONPATH=src python -m repro_torch.launch.spawn --procs 2 -- \\
        --backend spmd --smoke --stages 2 --steps 12 --device cpu ...

Elastic scenario in one invocation: ``--kill-pod-at S`` polls the run's
checkpoint manifest until its step is >= S, SIGKILLs the highest-index
process (the "lost pod"), tears the survivors down after ``--grace``
seconds, then starts ``--resume-procs M`` processes with the
``--resume-with`` train arguments (typically a smaller topology pointed at
the same ``--ckpt-dir``) and waits for them. One resumed process runs the
plain single-process path, with no coordinator. The exit status is 0 iff the
final phase ran to completion on every process.

Workers get this tree's ``src`` first on ``PYTHONPATH``, so they import the
same checkout, and, unless the caller set them, ``OMP_NUM_THREADS`` of
the machine's cores over the process count and one ``OPENBLAS_NUM_THREADS``,
so that N workers on one machine do not each start a pool of every core.
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence

from repro_torch.launch.distributed import ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID

_SRC_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(num_processes: int, process_id: int, coordinator: str) -> dict:
    env = dict(os.environ)
    env[ENV_COORDINATOR] = coordinator
    env[ENV_NUM_PROCESSES] = str(num_processes)
    env[ENV_PROCESS_ID] = str(process_id)
    env["PYTHONPATH"] = _SRC_DIR + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // num_processes)))
    # numpy's products in the data sampler are too small to gain from BLAS
    # threads, whose idle threads spin on the cores the other workers need
    env.setdefault("OPENBLAS_NUM_THREADS", "1")
    return env


def manifest_step(ckpt_dir: str) -> Optional[int]:
    """Step of the last committed checkpoint under ``ckpt_dir``, or None."""
    try:
        with open(os.path.join(ckpt_dir, "manifest.json")) as f:
            return int(json.load(f).get("step", 0))
    except (OSError, ValueError, TypeError):
        return None  # absent or mid-commit


def _terminate(procs: Sequence[subprocess.Popen], sig=signal.SIGTERM) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                p.send_signal(sig)
            except OSError:  # pragma: no cover — already reaped
                pass


def wait_all(procs: Sequence[subprocess.Popen], deadline: float) -> bool:
    """True iff every process exited 0 before ``deadline``."""
    while time.time() < deadline:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            return all(c == 0 for c in codes)
        if any(c not in (None, 0) for c in codes):
            # one worker died: the rest would hang on its collectives
            _terminate(procs)
        time.sleep(0.2)
    _terminate(procs, signal.SIGKILL)
    for p in procs:
        p.wait()
    return False


def launch_phase(num_processes: int, train_args: Sequence[str],
                 module: str = "repro_torch.launch.train") -> List[subprocess.Popen]:
    """Start ``num_processes`` ranks of ``python -m module train_args``
    under the environment contract, with a fresh coordinator port."""
    coordinator = f"127.0.0.1:{free_port()}"
    return [subprocess.Popen([sys.executable, "-m", module, *train_args],
                             env=worker_env(num_processes, i, coordinator))
            for i in range(num_processes)]


def _train_arg(train_args: Sequence[str], flag: str) -> Optional[str]:
    for i, a in enumerate(train_args):
        if a == flag and i + 1 < len(train_args):
            return train_args[i + 1]
        if a.startswith(flag + "="):
            return a.split("=", 1)[1]
    return None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, required=True,
                    help="process count for the first phase")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="overall wall-clock budget (seconds)")
    ap.add_argument("--kill-pod-at", type=int, default=0,
                    help="poll the run's --ckpt-dir manifest until this step "
                         "is committed, then SIGKILL the last process (the "
                         "'lost pod') and tear the phase down")
    ap.add_argument("--grace", type=float, default=10.0,
                    help="seconds survivors get to exit after the kill before SIGTERM")
    ap.add_argument("--resume-procs", type=int, default=0,
                    help="second phase: start this many processes after the first phase ends")
    ap.add_argument("--resume-with", default="",
                    help="full train argument string for the resume phase "
                         "(shlex-split), e.g. a smaller topology pointed at "
                         "the same --ckpt-dir")
    ap.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="arguments after -- go to repro_torch.launch.train")
    args = ap.parse_args(argv)
    if args.train_args and args.train_args[0] == "--":
        args.train_args = args.train_args[1:]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    deadline = time.time() + args.timeout

    print(f"[spawn] phase 1: {args.procs} processes: "
          f"train {' '.join(args.train_args)}", flush=True)
    procs = launch_phase(args.procs, args.train_args)

    if args.kill_pod_at:
        ckpt_dir = _train_arg(args.train_args, "--ckpt-dir")
        if not ckpt_dir:
            _terminate(procs, signal.SIGKILL)
            raise SystemExit("--kill-pod-at needs --ckpt-dir in the train args")
        victim = procs[-1]
        while time.time() < deadline:
            step = manifest_step(ckpt_dir)
            if step is not None and step >= args.kill_pod_at:
                break
            if all(p.poll() is not None for p in procs):
                print("[spawn] workers exited before the kill step", flush=True)
                return 1
            time.sleep(0.2)
        else:
            _terminate(procs, signal.SIGKILL)
            print("[spawn] timed out waiting for the kill step", flush=True)
            return 1
        print(f"[spawn] pod loss: SIGKILL process {args.procs - 1} "
              f"at checkpoint step >= {args.kill_pod_at}", flush=True)
        if victim.poll() is None:
            victim.send_signal(signal.SIGKILL)
        # survivors hang on the dead process's collectives; give them
        # --grace to fail on their own, then tear them down
        grace_end = min(time.time() + args.grace, deadline)
        while time.time() < grace_end:
            if all(p.poll() is not None for p in procs):
                break
            time.sleep(0.2)
        _terminate(procs)
        wait_all(procs, min(time.time() + 10, deadline))
        phase_ok = True  # an interrupted phase is the scenario, not a failure
    else:
        phase_ok = wait_all(procs, deadline)
        print(f"[spawn] phase 1 {'ok' if phase_ok else 'FAILED'}", flush=True)

    if not args.resume_procs:
        return 0 if phase_ok else 1

    resume_args = shlex.split(args.resume_with)
    print(f"[spawn] phase 2: {args.resume_procs} processes: "
          f"train {' '.join(resume_args)}", flush=True)
    if args.resume_procs == 1:
        # single-process resume: no coordinator, the plain train path
        env = worker_env(1, 0, "unused")
        for k in (ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID):
            env.pop(k, None)
        procs2 = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *resume_args], env=env)]
    else:
        procs2 = launch_phase(args.resume_procs, resume_args)
    ok = wait_all(procs2, deadline)
    print(f"[spawn] phase 2 {'ok' if ok else 'FAILED'}", flush=True)
    return 0 if ok and phase_ok else 1


if __name__ == "__main__":
    sys.exit(main())
