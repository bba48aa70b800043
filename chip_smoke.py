#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc``.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the main paths give it, plus ragged, batched and masked shapes,
   and times kernel, plain version and library call with CUDA events. B4
   runs per shape as a group of one and as the grouped launches of the
   paper_95m sim and SPMD paths, of the xlstm_1_3b sim path (8192-, 4096-
   and 2662-sided bases, the 3-D w_r) and of the paper_1b sim path (1728-
   and 6912-sided bases; each path's four groups, timed beside
   ``torch.matmul`` on their problems), a mixed ragged group for every pair of
   transpose flags and a group of one; B5 per shape as a group of one, then
   as one grouped launch over each path's rotated leaves (their own buffers,
   timed cold per step beside the per-leaf sequence) and over a ragged
   group, bitwise equal to its leaves launched alone, and the same groups
   through its in-place entry (v' written over v, as the training paths
   call it), bitwise equal to the copying entry; B1, B2 and B3 must
   each repeat bitwise. ptxas must report no spill stores for B5, nor for
   any of B1-B3's 24 instantiations (3 kernels, 2 input types, head widths
   16, 32, 64 and 128), nor for B4's four. B1-B3's
   bfloat16 entry points run the same cases on bf16 inputs (O, dQ, dK, dV
   within 1e-2 of their plain versions, L within 1e-5, bitwise repeats) and
   are timed at the path shape beside SDPA in bf16. At head dim 128 both
   entry points run qwen3_0_6b's path shape (16, 256, 128) and a windowed
   ragged case (4, 200, 128), window 100, under the same gates, and are
   timed at the path shape beside SDPA. The bf16 B1 (wgmma,
   flash_fwd_bf16.cu) and B2 and B3 (flash_bwd_bf16.cu) print, at both path
   shapes, their time beside SDPA's bf16 forward or backward, ptxas's
   registers and spills, their error against float64 (held within
   F64_ERR_FACTOR of the plain versions') and their tensor maps' host ns,
   each beside the old kernels' (``flash_bf16_fwd``, ``flash_bf16_bwd``).
3. Drives the sim path through ``repro_torch.launch.train.main``: the
   full-width paper_95m model, 8-stage simulated staleness, basis-rotation
   Adam with ``--use-kernels``, for 12 steps. Checks that the losses are
   finite and that every rotation product and rotated Adam step went through
   the kernels, by their launch counts (four grouped B4 launches and one
   grouped B5 launch per step).
4. Holds both SPMD schedules' gradients at full width, through B1-B3, to
   the whole-model gradient on one batch. Then drives the SPMD path like
   the sim path: full-width paper_95m on 8 stacked stages with 8
   microbatches, basis rotation and ``--use-kernels``, under the 1F1B
   schedule for 12 steps and the fill-drain schedule for 4 (the cosine
   schedule's length is the step count, so the two curves differ after the
   first steps). Checks finite losses and the exact launch counts of all
   five kernels. ``spmd_bf16`` trains the 1F1B path under ``--precision
   bf16`` for 4 steps: B1-B3 through their bf16 entry points only (2 M L and
   M L launches a step), B4 and B5 as in float32; then one more step under
   the dtype check (``analysis.dtype``: bfloat16 and float32 only, bfloat16
   present, masters and optimizer state float32).
   Then three phases of the other paths, each with every launch count
   zeroed just before and read just after, writing checkpoints to a
   temporary directory that the phase deletes (it first checks that the
   disk has twice the checkpoint's bytes free):
   ``resume_sim`` trains the sim path of phase 3 (built for 12 steps) for
   steps 0-5, checkpoints at step 6, and resumes a fresh trainer from that
   checkpoint through the launcher (``--ckpt-dir``; the stream fast-forwards
   six batches) for steps 6-11, across the refresh at step 10;
   ``resume_spmd`` does the same for the fill-drain SPMD path of phase 4
   (built for 4 steps) in the sharded format, cut at step 2. Resumed losses
   must be within 1e-6 of phases 3 and 4. ``sim_modes`` trains the sim path
   for 2 steps in each of ``--no-stash`` and ``--weight-prediction``. Each
   checks finite losses and the launch counts of the steps it ran, and
   reports the snapshot, write, load and fast-forward seconds, the
   checkpoint's bytes and the peak memory.
   ``baselines`` trains the paper's baseline optimizers on one list of three
   batches sampled once: each of the seven on the sim path for 3 steps, and
   delay compensation, pipedream_lr and muon on the SPMD 1F1B path for 3.
   Each run's first loss must equal phase 3's (sim) or phase 4's 1F1B one
   within 1e-6; B4 and B5 (basis rotation's) launch 0 times, B1-B3 as the
   1F1B path launches them. It reports each run's losses, step times, peak
   memory and, for delay compensation, its weight queues' bytes.
   ``catalog_1f1b`` trains the full-width qwen3_0_6b (28 layers, head dim
   128, GQA 16/8, qk_norm, vocab 151,936) through the launcher on the SPMD
   1F1B path (4 stages, 8 microbatches, basis rotation, ``--use-kernels``)
   for 3 steps in ``--precision f32`` and 3 in ``bf16``, from one list of
   three batches sampled once: finite losses and per step B1 448, B2 and B3
   224 launches (in the entry point of the policy), B4 4 and B5 1; then one
   bf16 step under the dtype check. ``serve_decode`` serves the full-width
   qwen3_0_6b on the card (batch 4, prompt 8, 24 tokens): in float32
   compute the decoded logits at the prompt's positions must equal
   ``forward_train``'s within 2e-4; then in its own bf16; tokens/s of both.
   ``xlstm_sim`` trains the full-width xlstm_1_3b, cut to one superblock of
   its pattern (8 layers: seven mLSTM blocks and one sLSTM; ``xlstm_cut``),
   through the launcher on the sim path (8 stages, basis rotation,
   ``--use-kernels``) for 4 steps: finite losses, per step four B4 launches
   and one B5 launch over its 39 rotated leaves, B1-B3 none; then
   ``profile_step`` breaks down two of its steps. ``serve_decode_xlstm``
   serves the same cut like qwen3_0_6b, its float32 prompt logits within the
   reference's xLSTM consistency tolerance (1e-3) of ``forward_train``'s.
   ``paper_1b_sim`` trains the paper's 1B model (24 layers, d_model 1728,
   27 heads of dh 64, d_ff 6912, vocab 50,304) at full width through the
   launcher on the sim path (8 stages, basis rotation, ``--use-kernels``)
   for 12 steps, after printing what the step must hold by kind, reckoned
   on the meta device (``reckon_sim``; layers are cut only if that does not
   fit): finite losses, per step four B4 launches and one B5 launch (in
   place) over its 144 rotated leaves, B1-B3 none, and the peak beside the
   reckoning. ``peaks`` prints the peaks of phases 3-4, ``catalog_1f1b``
   and ``xlstm_sim`` beside theirs before the optimizer state was updated
   in place, and fails if any grew. Every training path updates its
   optimizer state in place on the card (the sim engine always, the SPMD
   engine by ``donate="auto"``), so every B5 call of a path goes through
   the in-place entry: ``run_path`` fails any that writes v' beside v.
5. Runs the reduced model for a few steps on the card and on the CPU (plain
   kernel versions) from the same seed, on both backends (and both SPMD
   schedules, and the sim backend's no-stash and weight-prediction modes),
   with Adam and with basis rotation through the kernels, and compares the
   losses; then each baseline on the sim backend and the SPMD 1F1B one, the
   public architectures (qwen3_0_6b on 1F1B at head dim 128, qwen1_5_0_5b on
   the sim path, phi4_mini_3_8b_swa on 1F1B with a window of 16, xlstm_1_3b
   on the sim path) with Adam and basis rotation, and the SPMD 1F1B path in
   bf16 (first loss within 1e-2, all within 5e-2).

Each phase prints one JSON line; then the kernel table, the card's line
from ``nvidia-smi``, and last ``{"ok": true, "device": {...}}``. Any failure
raises and the exit code is not 0. Without CUDA, or without the repository's
``src/`` beside it, it exits non-zero before printing any result. Details
(the compiler's register report, the per-shape timings) go to
``chiprun_out/``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

MAIN_ARGS = ["--arch", "paper_95m", "--backend", "sim", "--stages", "8",
             "--optimizer", "basis_rotation", "--use-kernels", "--steps", "12",
             "--batch", "8", "--seq", "256", "--log-every", "1"]
SMOKE_ARGS = ["--smoke", "--stages", "2", "--steps", "4", "--batch", "4",
              "--seq", "32", "--log-every", "0"]
SPMD_ARGS = ["--arch", "paper_95m", "--backend", "spmd", "--stages", "8",
             "--microbatches", "8", "--optimizer", "basis_rotation", "--use-kernels",
             "--batch", "8", "--seq", "256", "--log-every", "1"]
SPMD_STEPS = {"1f1b": 12, "fill_drain": 4}
BF16_STEPS = 4  # steps of the 1F1B path under --precision bf16
RESUME_CUT = {"sim": 6, "spmd": 2}  # the step each resume check checkpoints at
MODE_STEPS = 2  # steps of each sim staleness mode
# the paper's baselines: each on the sim path, and three on the SPMD 1F1B path
# (the stage weight queues, per-stage factors, Newton-Schulz over stacked leaves)
BASELINES_SIM = ("adasgd", "nesterov", "nesterov_pp", "pipedream_lr", "delay_compensation",
                 "muon", "scion")
BASELINES_SPMD = ("delay_compensation", "pipedream_lr", "muon")
BASELINE_STEPS = {"sim": 3, "spmd": 3}
FIRST_LOSS_TOL = 1e-6  # a first loss against phase 3's or 4's: same weights and batch, no update
# card against CPU at smoke size: the elementwise baselines differ by float32
# summation order, as Adam does; Newton-Schulz's quintic steps amplify that in
# the smallest singular directions (muon, scion), and scion's sign flips where
# its momentum is within roundoff of zero
NEWTON_SCHULZ = ("muon", "scion")
RESUME_TOL = 1e-6  # resumed losses against the uninterrupted run's, same card and code
# qwen3_0_6b at full width on the SPMD 1F1B path: 4 stages of 7 layers (its
# 28 layers fix the stage counts that divide them), 8 microbatches of one
# sequence; CATALOG_STEPS steps in float32 and then in bf16 on one list of
# batches sampled once (host sampling at vocab 151,936 costs seconds a batch)
CATALOG_ARGS = ["--arch", "qwen3_0_6b", "--backend", "spmd", "--schedule", "1f1b",
                "--stages", "4", "--microbatches", "8", "--optimizer", "basis_rotation",
                "--use-kernels", "--batch", "8", "--seq", "256", "--log-every", "1"]
CATALOG_STEPS = 3
SERVE = {"batch": 4, "prompt_len": 8, "gen_len": 24}  # full-width qwen3_0_6b decode
DECODE_TOL = 2e-4  # decode against the training forward (tests/test_models.py:35)
# xlstm_1_3b at full width, cut to one superblock of its pattern: 8 of its 48
# layers, seven mLSTM blocks and the sLSTM at position 3 (the 48 with their
# bases and Adam state do not fit one card). The sim path on 8 stages, the
# first of its steps a refresh; then its decode, held to the reference's xLSTM
# consistency tolerance (tests/test_models.py:83-89)
XLSTM_LAYERS = 8
XLSTM_ARGS = ["--arch", "xlstm_1_3b", "--backend", "sim", "--stages", "8",
              "--optimizer", "basis_rotation", "--use-kernels", "--steps", "4",
              "--batch", "8", "--seq", "256", "--log-every", "1"]
XLSTM_DECODE_TOL = 1e-3
# paper_1b (the abstract's 1B model) at full width on the sim path: 8 stages,
# basis rotation (second-moment source, bilateral, refresh every 10 steps),
# 12 steps so that the refresh at step 10 is timed apart from the first step.
# The layers are cut only if the reckoning (``reckon_sim``) does not fit the card
PAPER_1B_ARGS = ["--arch", "paper_1b", "--backend", "sim", "--stages", "8",
                 "--optimizer", "basis_rotation", "--use-kernels", "--steps", "12",
                 "--batch", "8", "--seq", "256", "--log-every", "1"]
# peak device memory (GB) of the earlier paths before the optimizer state was
# updated in place (chip_smoke.py on one H100 80GB HBM3 at 700 W, PERF.md §5):
# the state is now updated in its own tensors, so none may grow past these
EARLIER_PEAKS_GB = {"main_path": 7.898, "spmd_1f1b": 9.11, "catalog_1f1b": 57.23,
                    "xlstm_sim": 60.08}

# Published dense peaks (NVIDIA data sheets): float32 outside the tensor
# cores, device memory bandwidth, TF32 and bf16 on the tensor cores. The SXM
# part is the default.
PEAKS = {
    "PCIe": (51.2e12, 2.0e12, 378e12, 756e12),
    "NVL": (60.0e12, 3.9e12, 417.5e12, 835e12),
    "SXM": (67.0e12, 3.35e12, 495e12, 989e12),
}
TF32_PASSES = 3  # the 3xTF32 split: three tensor-core products per float32 product
LONG_GROUP_FLOPS = 2e12  # a B4 group timed over 3 launches, not 10 (xlstm_1_3b's, paper_1b's)

SLEEP_CYCLES = 50_000_000  # ~25 ms at 2 GHz: longer than the host takes to enqueue a timing run
# ~0.2 s at 2 GHz: longer than the host takes to enqueue one step's B5 work leaf by leaf
STEP_SLEEP_CYCLES = 400_000_000
ADAM_SCALARS = (0.999, 1e-8, 1 - 0.9 ** 4, 1 - 0.999 ** 4)  # beta2, eps, bc1, bc2 at step 4
# leaves per timed run of B5's plain version: its seven kernels a leaf must all wait
# in the launch queue behind one sleep
PLAIN_LEAVES_PER_RUN = 32
MATMUL_RTOL, MATMUL_ATOL = 2e-3, 1e-4  # tests/test_kernels.py rotation parity
ADAM_RTOL, ADAM_ATOL = 1e-5, 1e-6  # tests/test_kernels.py fused Adam parity
FWD_RTOL, FWD_ATOL = 2e-3, 2e-4  # tests/test_kernels.py:87 flash forward parity
BWD_RTOL, BWD_ATOL = 2e-3, 1e-4  # tests/test_kernels.py:137-142 flash backward parity
FLASH_PATH = (6, 256, 64)  # (heads, S, dh) of one attention call on the paper_95m path
# one attention call of qwen3_0_6b's 1F1B path: 16 query heads (its 8 KV heads
# repeated to 16), one microbatch of one sequence of 256, head dim 128
QWEN3_FLASH_PATH = (16, 256, 128)
# B1-B3 on bf16 inputs against their plain versions on the same inputs: O, dQ,
# dK and dV are each rounded to bf16 once (2^-8 relative); L is float32
BF16_TOL, BF16_L_TOL = 1e-2, 1e-5
# B1-B3 at the path shape: relative error against a float64 forward or backward at
# most this many times the plain version's. One TF32 pass instead of three is ~1e3
# times off.
F64_ERR_FACTOR = 4
# the bf16 B2 and B3 before their redesign for wgmma (16-row blocks on mma.sync,
# P and dS in float32), at each path shape: us per launch (PERF.md section 6) and
# relative error against float64 (launch/bench_flash.py on that tree), one NVIDIA
# H100 80GB HBM3 at 700 W; phase 2 prints the new kernels' own beside them
OLD_BF16_BWD = {
    (6, 256, 64): {"flash_bwd_dq": {"us": 9.79, "rel_err_f64": 1.6498e-3},
                   "flash_bwd_dkv": {"us": 11.26, "rel_err_f64": 1.6839e-3}},
    (16, 256, 128): {"flash_bwd_dq": {"us": 17.86, "rel_err_f64": 1.6571e-3},
                     "flash_bwd_dkv": {"us": 32.24, "rel_err_f64": 1.6594e-3}},
}
# B1 before its redesign for wgmma (16-row blocks on mma.sync, P V in 2xTF32) on
# bf16 inputs, at each path shape: us per launch (PERF.md section 6), one NVIDIA
# H100 80GB HBM3 at 700 W; phase 2 prints the new kernel's own beside them
OLD_BF16_FWD = {(6, 256, 64): {"us": 10.37}, (16, 256, 128): {"us": 21.02}}
# B1, B2 and B3 x float32 and bf16 entry points (each its own kernel) x head dims
# 16, 32, 64, 128
FLASH_INSTANTIATIONS = 24


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it ended, in seconds
    since the script started."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    return "SXM", PEAKS["SXM"]


def time_ms(fn, reps: int = 30, warmup: int = 5):
    """Device time of one call of ``fn``: median over ``reps`` back-to-back
    calls, each between its own pair of CUDA events. A sleep kernel keeps the
    card busy while the host enqueues them all, so the host's own cost per
    call (returned second, in ms) does not show in the device time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    host_ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(reps)), host_ms


def product_counts(groups):
    """{(batch, M, K, N, trans_a, trans_b): count} over a step's groups."""
    return Counter(key for group in groups for key in group)


def mm_work(problems):
    """(flops, bytes) of a list of products: each input read once, each
    output written once."""
    flops = sum(2.0 * b * M * K * N for b, M, K, N, _, _ in problems)
    nbytes = sum(4.0 * b * (M * K + K * N + M * N) for b, M, K, N, _, _ in problems)
    return flops, nbytes


def time_step_ms(fn, reps: int = 10, warmup: int = 2):
    """Device time of one step's work ``fn``: median over ``reps`` runs, each
    alone between its own pair of CUDA events behind a sleep kernel. Also
    the host's median time to issue it (ms) and whether every run was
    issued before its sleep ended, so that no host gap lies between the
    events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    dev, host, issued_ahead = [], [], True
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(STEP_SLEEP_CYCLES)
        ev[1].record()
        t0 = time.perf_counter()
        fn()
        host.append(1e3 * (time.perf_counter() - t0))
        ev[2].record()
        torch.cuda.synchronize()
        issued_ahead = issued_ahead and host[-1] < ev[0].elapsed_time(ev[1])
        dev.append(ev[1].elapsed_time(ev[2]))
    return statistics.median(dev), statistics.median(host), issued_ahead


def time_leaves_ms(fn, leaves: int, per_run: int, split: bool = True):
    """``time_step_ms`` of ``fn(lo, hi)`` over leaves lo <= i < hi, in runs of
    at most ``per_run`` leaves, summed over the runs: (device ms, host ms,
    leaves per run). A run that the host did not issue before its sleep
    ended would count host gaps as device time, so then the runs are halved
    and timed again when ``split`` allows it; otherwise this raises."""
    while True:
        runs = [time_step_ms(lambda lo=lo: fn(lo, min(lo + per_run, leaves)))
                for lo in range(0, leaves, per_run)]
        if all(r[2] for r in runs):
            return sum(r[0] for r in runs), sum(r[1] for r in runs), per_run
        if not split or per_run == 1:
            raise AssertionError(f"runs of {per_run} leaves not issued ahead of the card: "
                                 f"host {[r[1] for r in runs]} ms")
        per_run //= 2


def ptxas_report(log: str, kernel: str):
    """{entry function: {"registers", "spill_stores"}} from ``nvcc -Xptxas -v``
    output, for the entry functions whose (mangled) name holds ``kernel``."""
    out = {}
    for block in log.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if kernel in name:
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            out[name] = {"registers": int(regs.group(1)) if regs else None,
                         "spill_stores": int(spill.group(1)) if spill else None}
    return out


def flash_entry(mangled: str) -> str:
    """``flash_fwd_kernel<64, f32>`` for a flash kernel's mangled name: its
    head width and its input type (the bf16 kernels,
    ``flash_fwd_bf16_kernel<64, bf16>`` and ``flash_bwd_dq_bf16_kernel<64,
    bf16>``, take bf16 pointers)."""
    m = re.search(r"(flash_\w+?_kernel)ILi(\d+)E", mangled)
    return f"{m.group(1)}<{m.group(2)}, {'bf16' if 'bfloat16' in mangled else 'f32'}>"


def bf16_source(src: str) -> str:
    """The source of a flash kernel's bf16 entry point: each has a file of
    its own."""
    return src.replace("flash_bwd.cu", "flash_bwd_bf16.cu").replace(
        "flash_fwd.cu", "flash_fwd_bf16.cu")


def bounds(flops, nbytes, peaks, passes=1):
    """(least ms on the tensor route, least ms on the float32 FMA route,
    what bounds the first)."""
    t_tc, t_f32, t_bytes = passes * flops / peaks[2], flops / peaks[0], nbytes / peaks[1]
    return (1e3 * max(t_tc, t_bytes), 1e3 * max(t_f32, t_bytes),
            "operations" if t_tc >= t_bytes else "bytes")


def _operands(torch, gen, problems, two_d=False):
    """Random operands of a list of problems, scaled so outputs are O(1)."""
    As, Bs = [], []
    for b, M, K, N, ta, tb in problems:
        a = torch.randn((b, K, M) if ta else (b, M, K), device="cuda", generator=gen)
        x = torch.randn((b, N, K) if tb else (b, K, N), device="cuda", generator=gen)
        a /= math.sqrt(K)
        if two_d and b == 1:
            a, x = a[0], x[0]
        As.append(a)
        Bs.append(x)
    return As, Bs


def check_matmul_groups(torch, kmm, paths, peaks):
    """The grouped B4 launch against its plain version: each path's four
    groups with the path's shapes and flags, a mixed-shape ragged group for
    every flag pair, and a group of one. Times each path group, one event
    pair per launch, its plain version and ``torch.matmul`` on contiguous
    operands of each of its problems. Returns (rows, max_abs_err)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, worst = [], 0.0
    cases = [(f"{path}/{i}", problems, True)
             for path, groups in paths.items() for i, problems in enumerate(groups)]
    ragged = [(1, 100, 70, 50), (1, 17, 33, 65), (3, 100, 70, 50), (2, 130, 257, 129),
              (1, 384, 384, 384), (1, 200, 64, 96)]
    for ta, tb in ((True, False), (False, False), (False, True), (True, True)):
        cases.append((f"ragged/{int(ta)}{int(tb)}",
                      [(b, M, K, N, ta, tb) for b, M, K, N in ragged], False))
    cases.append(("one", [(1, 384, 1536, 1536, False, True)], False))
    for name, problems, timed in cases:
        ta, tb = problems[0][4:]
        As, Bs = _operands(torch, gen, problems, two_d=not timed)
        before = kmm.matmul.launches
        outs = kmm.matmul_grouped(As, Bs, trans_a=ta, trans_b=tb)
        launches = kmm.matmul.launches - before
        wants = kmm.matmul_grouped_plain(As, Bs, trans_a=ta, trans_b=tb)
        torch.cuda.synchronize()
        err = torch.stack([(o - w).abs().max() for o, w in zip(outs, wants)]).max().item()
        worst = max(worst, err)
        if launches != 1 or not all(torch.allclose(o, w, rtol=MATMUL_RTOL, atol=MATMUL_ATOL)
                                    for o, w in zip(outs, wants)):
            raise AssertionError(f"matmul_grouped {name}: {launches} launches, "
                                 f"max abs err {err}")
        row = {"group": name, "problems": len(problems), "trans_a": ta, "trans_b": tb,
               "max_abs_err": err}
        del outs, wants
        if timed:
            flops, nbytes = mm_work(problems)
            # a group of more than LONG_GROUP_FLOPS takes 50 ms or more a
            # launch, whose spread is well below a percent: fewer repeats
            reps, warmup = (3, 1) if flops > LONG_GROUP_FLOPS else (10, 2)
            row["ms"], row["host_ms"] = time_ms(
                lambda: kmm.matmul_grouped(As, Bs, trans_a=ta, trans_b=tb), reps, warmup)
            row["plain_ms"], _ = time_ms(
                lambda: kmm.matmul_grouped_plain(As, Bs, trans_a=ta, trans_b=tb), reps, warmup)
            lib = [((a.mT if ta else a).contiguous(), (b.mT if tb else b).contiguous())
                   for a, b in zip(As, Bs)]
            row["library_ms"], _ = time_ms(lambda: [torch.matmul(a, b) for a, b in lib],
                                           reps, warmup)
            del lib
            row["bound_ms"], row["bound_fp32_ms"], _ = bounds(flops, nbytes, peaks, TF32_PASSES)
            row["tflops"] = flops / row["ms"] / 1e9
        rows.append(row)
        del As, Bs
        torch.cuda.empty_cache()
    return rows, worst


def check_matmul(torch, kmm, peaks):
    """B4 as a group of one at the path shapes (every transpose flag the
    path uses), plus ragged and batched shapes; per shape, times the kernel,
    its plain version and ``torch.matmul``. Returns (rows, max_abs_err)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], 0.0
    shapes = [(1, 384, 384, 384), (1, 384, 384, 1536), (1, 384, 1536, 1536),
              (1, 1536, 1536, 384), (1, 1536, 384, 384)]
    flags = [(True, False), (False, False), (False, True)]
    cases = [(s, f, True) for s in shapes for f in flags]
    # the SPMD path's stacked leaves: one launch batched over the 32 layers
    cases += [((32,) + s[1:], f, True) for s in shapes for f in flags]
    cases += [((1, 100, 70, 50), f, False) for f in flags + [(True, True)]]
    cases += [((3, 100, 70, 50), (True, False), False), ((4, 96, 80, 72), (False, True), False)]
    for (batch, M, K, N), (ta, tb), timed in cases:
        a_shape = (batch, K, M) if ta else (batch, M, K)
        b_shape = (batch, N, K) if tb else (batch, K, N)
        a = torch.randn(a_shape, device="cuda", generator=gen) / math.sqrt(K)
        b = torch.randn(b_shape, device="cuda", generator=gen)
        if batch == 1:
            a, b = a[0], b[0]
        out = kmm.matmul(a, b, trans_a=ta, trans_b=tb)
        want = kmm.matmul_plain(a, b, trans_a=ta, trans_b=tb)
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(out, want, rtol=MATMUL_RTOL, atol=MATMUL_ATOL):
            raise AssertionError(f"matmul {(batch, M, K, N, ta, tb)}: max abs err {err}")
        row = {"shape": [batch, M, K, N], "trans_a": ta, "trans_b": tb, "max_abs_err": err}
        if timed:
            a_lib = (a.mT if ta else a).contiguous()
            b_lib = (b.mT if tb else b).contiguous()
            row["ms"], row["host_ms"] = time_ms(lambda: kmm.matmul(a, b, trans_a=ta, trans_b=tb))
            row["plain_ms"], _ = time_ms(lambda: kmm.matmul_plain(a, b, trans_a=ta, trans_b=tb))
            row["library_ms"], _ = time_ms(lambda: torch.matmul(a_lib, b_lib))
            flops, nbytes = mm_work([(batch, M, K, N, ta, tb)])
            row["bound_ms"], row["bound_fp32_ms"], _ = bounds(flops, nbytes, peaks, TF32_PASSES)
            row["tflops"] = flops / row["ms"] / 1e9
        rows.append(row)
    return rows, worst


def check_adam(torch, kadam):
    """B5 as a group of one at the path shapes, a ragged shape and a
    first-step (v = 0) case."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    beta2, eps, bc1, bc2 = ADAM_SCALARS
    rows, worst = [], 0.0
    cases = [((384, 384), False), ((384, 1536), False), ((1536, 384), False),
             ((97, 33), False), ((384, 384), True), ((8, 4, 384, 384), False),
             ((8, 4, 384, 1536), False), ((8, 4, 1536, 384), False)]
    for shape, zero_v in cases:
        g = torch.randn(shape, device="cuda", generator=gen) * 1e-3
        m = torch.randn(shape, device="cuda", generator=gen) * 1e-3
        v = torch.zeros(shape, device="cuda") if zero_v else (
            torch.randn(shape, device="cuda", generator=gen).abs() * 1e-6 + 1e-8)
        before = kadam.adam_scale.launches
        step, v_new = kadam.adam_scale(g, m, v, beta2, eps, bc1, bc2)
        if kadam.adam_scale.launches != before + 1:
            raise AssertionError(f"adam_scale {shape}: {kadam.adam_scale.launches - before} "
                                 "launches")
        s_want, v_want = kadam.adam_scale_plain(g, m, v, beta2, eps, bc1, bc2)
        torch.cuda.synchronize()
        err = max((step - s_want).abs().max().item(), (v_new - v_want).abs().max().item())
        rel = max(((step - s_want).abs() / s_want.abs().clamp(min=ADAM_ATOL)).max().item(),
                  ((v_new - v_want).abs() / v_want.abs().clamp(min=ADAM_ATOL)).max().item())
        worst = max(worst, err)
        if not (torch.allclose(step, s_want, rtol=ADAM_RTOL, atol=ADAM_ATOL)
                and torch.allclose(v_new, v_want, rtol=ADAM_RTOL, atol=ADAM_ATOL)):
            raise AssertionError(f"adam_scale {shape} (v=0: {zero_v}): max abs err {err}")
        rows.append({"shape": list(shape), "zero_v": zero_v, "max_abs_err": err,
                     "max_rel_err": rel, "bitwise_equal": bool(
                         torch.equal(step, s_want) and torch.equal(v_new, v_want))})
    return rows, worst


def _adam_leaves(torch, gen, shapes):
    """g, m, v of their own for each leaf shape, at the sizes of a rotated
    step (v > 0)."""
    gs, ms, vs = [], [], []
    for shape in shapes:
        gs.append(torch.randn(shape, device="cuda", generator=gen) * 1e-3)
        ms.append(torch.randn(shape, device="cuda", generator=gen) * 1e-3)
        vs.append(torch.randn(shape, device="cuda", generator=gen).abs() * 1e-6 + 1e-8)
    return gs, ms, vs


def check_adam_groups(torch, kadam, paths, peaks):
    """The grouped B5 launch over each path's rotated leaves and over a
    ragged group (a g that starts 4 bytes past a 16-byte boundary, a
    97 x 33 leaf, empty and batched leaves beside aligned ones). Each leaf
    has buffers of its own, so a step's 1.13 GB cannot sit in L2. Each group
    must take one launch, stay within the Adam tolerances of the plain
    version, and be bitwise equal to its leaves launched alone. The
    in-place entry (v' written over v: the kernel's ``v_out`` is ``v``),
    which the training paths call, runs each group on copies of v: one
    launch, within the same tolerances of the plain version, bitwise equal
    to the copying entry, v' in v's own tensors. Times each path's step
    cold (``time_leaves_ms``): the grouped launch through both entries, the
    per-leaf sequence of groups of one and the plain version (in runs of at
    most ``PLAIN_LEAVES_PER_RUN`` leaves; writing v' over v changes where
    its result lands, not its work, so it is timed once).
    Returns (rows, max_abs_err over both entries)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows, worst = [], 0.0
    ragged = [(384, 1536), (384, 384), (97, 33), (0, 16), (8, 4, 40, 24), (5,), (0,)]
    for name, shapes in (*paths.items(), ("ragged", ragged)):
        gs, ms, vs = _adam_leaves(torch, gen, shapes)
        if name == "ragged":
            off = torch.empty(gs[1].numel() + 1, device="cuda")
            off[1:] = gs[1].reshape(-1)
            gs[1] = off[1:].view(gs[1].shape)
        before = kadam.adam_scale.launches
        steps, v_news = kadam.adam_scale_grouped(gs, ms, vs, *ADAM_SCALARS)
        launches = kadam.adam_scale.launches - before
        v_in = [v.clone() for v in vs]
        before = kadam.adam_scale.launches
        steps_in, v_out = kadam.adam_scale_grouped(gs, ms, v_in, *ADAM_SCALARS, inplace=True)
        launches_in = kadam.adam_scale.launches - before
        err, err_in, close, one = 0.0, 0.0, True, True
        aliased = all(a is b for a, b in zip(v_out, v_in))
        for g, m, v, s, vn, s_in, vn_in in zip(gs, ms, vs, steps, v_news, steps_in, v_in):
            s_one, vn_one = kadam.adam_scale(g, m, v, *ADAM_SCALARS)
            s_p, vn_p = kadam.adam_scale_plain(g, m, v, *ADAM_SCALARS)
            if g.numel():
                err = max(err, (s - s_p).abs().max().item(), (vn - vn_p).abs().max().item())
                err_in = max(err_in, (s_in - s_p).abs().max().item(),
                             (vn_in - vn_p).abs().max().item())
            close = close and all(torch.allclose(x, w, rtol=ADAM_RTOL, atol=ADAM_ATOL)
                                  for x, w in ((s, s_p), (vn, vn_p), (s_in, s_p), (vn_in, vn_p)))
            one = one and torch.equal(s, s_one) and torch.equal(vn, vn_one)
            aliased = aliased and torch.equal(s_in, s) and torch.equal(vn_in, vn)
        del steps, v_news, steps_in, v_out
        worst = max(worst, err, err_in)
        if not (launches == 1 and launches_in == 1 and close and one and aliased):
            raise AssertionError(f"adam_scale_grouped {name}: {launches} + {launches_in} "
                                 f"launches, max abs err {err} (in place {err_in}), bitwise to "
                                 f"groups of one {one}, in place bitwise and in v {aliased}")
        elements = sum(g.numel() for g in gs)
        row = {"group": name, "leaves": len(shapes), "elements": elements, "max_abs_err": err,
               "inplace_max_abs_err": err_in, "bitwise_groups_of_one": one,
               "inplace_bitwise": aliased}
        if name != "ragged":
            n = len(gs)
            for key, per_run, fn in (
                    ("ms", n, lambda lo, hi: kadam.adam_scale_grouped(
                        gs[lo:hi], ms[lo:hi], vs[lo:hi], *ADAM_SCALARS)),
                    ("inplace_ms", n, lambda lo, hi: kadam.adam_scale_grouped(
                        gs[lo:hi], ms[lo:hi], v_in[lo:hi], *ADAM_SCALARS, inplace=True)),
                    ("per_leaf_ms", n, lambda lo, hi: [
                        kadam.adam_scale(g, m, v, *ADAM_SCALARS)
                        for g, m, v in zip(gs[lo:hi], ms[lo:hi], vs[lo:hi])]),
                    ("plain_ms", PLAIN_LEAVES_PER_RUN, lambda lo, hi: [
                        kadam.adam_scale_plain(g, m, v, *ADAM_SCALARS)
                        for g, m, v in zip(gs[lo:hi], ms[lo:hi], vs[lo:hi])])):
                row[key], row["host_" + key], row["leaves_per_run_" + key] = time_leaves_ms(
                    fn, n, per_run, split=key not in ("ms", "inplace_ms"))
            row["bound_ms"] = 1e3 * 20.0 * elements / peaks[1]
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["inplace_bound_share"] = row["bound_ms"] / row["inplace_ms"]
        rows.append(row)
        del gs, ms, vs, v_in
        torch.cuda.empty_cache()
    return rows, worst


def flash_work(BH: int, S: int, dh: int, elem: int = 4):
    """Work of the three flash kernels at one causal shape, over the visible
    entries only, with heads of ``elem`` bytes (L and D float32), each input
    read once and each output written once. Returns {kernel: (flops of the
    products of two inputs (QK^T, dO V^T), flops of the products of P or dS
    by an input, bytes)}."""
    prod = 2.0 * dh * (S * (S + 1) // 2) * BH  # one (S x S) by (S x dh) product
    head, row = float(elem) * BH * S * dh, 4.0 * BH * S
    return {"flash_fwd": (prod, prod, 3 * head + head + row),  # QK, PV; O and L
            "flash_bwd_dq": (2 * prod, prod, 4 * head + 2 * row + head),  # QK, dO V; dS K
            "flash_bwd_dkv": (2 * prod, 2 * prod, 4 * head + 2 * row + 2 * head)}


def flash_cases(path):
    """B1-B3's cases at a path shape: the path shape itself and, at the
    paper_95m path, the reference's sweeps (windows None, 100, 32; S 256,
    128, 200, 100) and a fully-masked row case; at head dim 128 a windowed
    case of ragged length."""
    if path[2] == 128:
        return [(path, None, None), ((4, 200, 128), 100, None)]
    cases = [(path, None, None)]
    cases += [((6, S, 64), w, None) for S in (256, 128) for w in (None, 100, 32)]
    cases += [((2, S, 32), w, None) for S in (200, 100) for w in (None, 100, 32, 16)]
    cases += [((1, 128, 16), 8, 100)]  # keys past 100 masked: rows >= 107 see none
    return cases


def check_flash(torch, kflash, peaks, path=FLASH_PATH):
    """B1-B3 against their plain versions on ``flash_cases(path)``; each
    kernel run twice on every case must repeat bitwise. Times all three,
    their plain versions and PyTorch's SDPA forward and backward at the path
    shape. Returns (rows, errs, timing)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, errs = [], {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for (BH, S, dh), window, seq_len in flash_cases(path):
        q, k, v, do = (torch.randn((BH, S, dh), device="cuda", generator=gen) for _ in range(4))
        o, L = kflash.flash_fwd(q, k, v, window=window, seq_len=seq_len)
        o2, L2 = kflash.flash_fwd(q, k, v, window=window, seq_len=seq_len)
        o_p, L_p = kflash.flash_fwd_plain(q, k, v, window=window, seq_len=seq_len)
        D = (do * o).sum(-1)
        dq = kflash.flash_bwd_dq(q, k, v, do, L, D, window=window)
        dq2 = kflash.flash_bwd_dq(q, k, v, do, L, D, window=window)
        dq_p = kflash.flash_bwd_dq_plain(q, k, v, do, L, D, window=window)
        dk, dv = kflash.flash_bwd_dkv(q, k, v, do, L, D, window=window)
        dk2, dv2 = kflash.flash_bwd_dkv(q, k, v, do, L, D, window=window)
        dk_p, dv_p = kflash.flash_bwd_dkv_plain(q, k, v, do, L, D, window=window)
        torch.cuda.synchronize()
        row = {"shape": [BH, S, dh], "window": window, "seq_len": seq_len}
        for name, pairs in (("flash_fwd", ((o, o2), (L, L2))), ("flash_bwd_dq", ((dq, dq2),)),
                            ("flash_bwd_dkv", ((dk, dk2), (dv, dv2)))):
            # bit patterns, so that a NaN repeats too: with seq_len the forward's L
            # is -1e30 on rows whose keys the backward sees, and their dS overflows
            row[name + "_bitwise_repeat"] = all(
                torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in pairs)
            if not row[name + "_bitwise_repeat"]:
                raise AssertionError(f"{name} {(BH, S, dh)} window={window}: two runs differ")
        for name, pairs, (rtol, atol) in (
                ("flash_fwd", ((o, o_p), (L, L_p)), (FWD_RTOL, FWD_ATOL)),
                ("flash_bwd_dq", ((dq, dq_p),), (BWD_RTOL, BWD_ATOL)),
                ("flash_bwd_dkv", ((dk, dk_p), (dv, dv_p)), (BWD_RTOL, BWD_ATOL))):
            if seq_len is not None and name != "flash_fwd":
                continue  # the backward always sees every key
            err = max((a - b).abs().max().item() for a, b in pairs)
            row[name + "_max_abs_err"] = err
            errs[name] = max(errs[name], err)
            if not all(torch.allclose(a, b, rtol=rtol, atol=atol) for a, b in pairs):
                raise AssertionError(f"{name} {(BH, S, dh)} window={window}: max abs err {err}")
        if seq_len is not None:
            dead = seq_len - 1 + window
            if not (o[:, dead:].abs().max().item() == 0.0 and bool((L[:, dead:] <= -1e29).all())):
                raise AssertionError("flash_fwd: fully-masked rows are not 0 with L = -1e30")
            row["fully_masked_rows_zero"] = True
        rows.append(row)

    # timing at the path shape: one attention call of one microbatch
    BH, S, dh = path
    q, k, v, do = (torch.randn((BH, S, dh), device="cuda", generator=gen) for _ in range(4))
    o, L = kflash.flash_fwd(q, k, v)
    D = (do * o).sum(-1)
    timing = {}
    # B2 and B3 against a float64 backward from the same inputs, L and D:
    # relative Frobenius error (of dK or dV, the larger), held to a multiple
    # of the plain version's
    x64 = [x.double() for x in (q, k, v, do, L, D)]
    want = {"flash_bwd_dq": (kflash.flash_bwd_dq_plain(*x64),),
            "flash_bwd_dkv": kflash.flash_bwd_dkv_plain(*x64)}
    for name, w in want.items():
        def rel(fn):
            got = fn(q, k, v, do, L, D)
            got = got if isinstance(got, tuple) else (got,)
            return max(float((x.double() - y).norm() / y.norm()) for x, y in zip(got, w))
        t = timing[name] = {"rel_err_f64": rel(getattr(kflash, name)),
                            "plain_rel_err_f64": rel(getattr(kflash, name + "_plain"))}
        if not t["rel_err_f64"] <= F64_ERR_FACTOR * t["plain_rel_err_f64"]:
            raise AssertionError(f"{name}: relative error {t['rel_err_f64']} against float64 "
                                 f"exceeds {F64_ERR_FACTOR}x the plain version's "
                                 f"{t['plain_rel_err_f64']}")
    for name, fn, plain in (
            ("flash_fwd", lambda: kflash.flash_fwd(q, k, v),
             lambda: kflash.flash_fwd_plain(q, k, v)),
            ("flash_bwd_dq", lambda: kflash.flash_bwd_dq(q, k, v, do, L, D),
             lambda: kflash.flash_bwd_dq_plain(q, k, v, do, L, D)),
            ("flash_bwd_dkv", lambda: kflash.flash_bwd_dkv(q, k, v, do, L, D),
             lambda: kflash.flash_bwd_dkv_plain(q, k, v, do, L, D))):
        t = timing.setdefault(name, {})
        t["ms"], t["host_ms"] = time_ms(fn)
        t["plain_ms"], _ = time_ms(plain)
    for name, n in kflash.launched_blocks().items():  # the grids of the timed launches
        timing[name]["blocks"] = n
    q4, k4, v4 = (x.reshape(1, BH, S, dh).clone().requires_grad_(True) for x in (q, k, v))
    with torch.no_grad():
        sdpa_fwd, _ = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.reshape(1, BH, S, dh)
    sdpa_bwd, _ = time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True))
    timing["flash_fwd"]["library_ms"] = sdpa_fwd
    # SDPA's backward computes dQ, dK and dV in one call: B2 and B3 together
    timing["flash_bwd_dq"]["library_ms"] = timing["flash_bwd_dkv"]["library_ms"] = sdpa_bwd
    for name, (f_in, f_p, nbytes) in flash_work(BH, S, dh).items():  # all in 3xTF32
        tc, f32, by = bounds(f_in + f_p, nbytes, peaks, TF32_PASSES)
        timing[name].update(bound_ms=tc, bound_fp32_ms=f32, bound_by=by)
    return rows, errs, timing


def check_flash_bf16(torch, kflash, peaks, path=FLASH_PATH):
    """B1-B3's bfloat16 entry points against their plain versions on the
    same bf16 inputs: the float32 check's cases (``flash_cases(path)``),
    each kernel run twice and required to repeat bitwise. At the path shape:
    B1 against a float64 forward (O) and B2 and B3 against a float64
    backward, each within F64_ERR_FACTOR of its plain version's error, and
    the times of all three, their plain versions and SDPA's bf16 forward and
    backward. Returns (rows, errs, timing)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16 = torch.bfloat16
    rows, errs = [], {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for (BH, S, dh), window, seq_len in flash_cases(path):
        q, k, v, do = (torch.randn((BH, S, dh), device="cuda", generator=gen).to(bf16)
                       for _ in range(4))
        o, L = kflash.flash_fwd(q, k, v, window=window, seq_len=seq_len)
        o2, L2 = kflash.flash_fwd(q, k, v, window=window, seq_len=seq_len)
        o_p, L_p = kflash.flash_fwd_plain(q, k, v, window=window, seq_len=seq_len)
        D = (do.float() * o.float()).sum(-1)
        dq = kflash.flash_bwd_dq(q, k, v, do, L, D, window=window)
        dq2 = kflash.flash_bwd_dq(q, k, v, do, L, D, window=window)
        dq_p = kflash.flash_bwd_dq_plain(q, k, v, do, L, D, window=window)
        dk, dv = kflash.flash_bwd_dkv(q, k, v, do, L, D, window=window)
        dk2, dv2 = kflash.flash_bwd_dkv(q, k, v, do, L, D, window=window)
        dk_p, dv_p = kflash.flash_bwd_dkv_plain(q, k, v, do, L, D, window=window)
        torch.cuda.synchronize()
        if not all(x.dtype == bf16 for x in (o, dq, dk, dv)) or L.dtype != torch.float32:
            raise AssertionError("flash bf16 output dtypes "
                                 f"{[x.dtype for x in (o, L, dq, dk, dv)]}")
        row = {"shape": [BH, S, dh], "window": window, "seq_len": seq_len}
        for name, pairs in (("flash_fwd", ((o, o2), (L, L2))), ("flash_bwd_dq", ((dq, dq2),)),
                            ("flash_bwd_dkv", ((dk, dk2), (dv, dv2)))):
            row[name + "_bitwise_repeat"] = all(
                torch.equal(a.view(torch.int16 if a.dtype == bf16 else torch.int32),
                            b.view(torch.int16 if b.dtype == bf16 else torch.int32))
                for a, b in pairs)
            if not row[name + "_bitwise_repeat"]:
                raise AssertionError(f"{name} bf16 {(BH, S, dh)} window={window}: two runs differ")
        for name, pairs in (("flash_fwd", ((o, o_p, BF16_TOL), (L, L_p, BF16_L_TOL))),
                            ("flash_bwd_dq", ((dq, dq_p, BF16_TOL),)),
                            ("flash_bwd_dkv", ((dk, dk_p, BF16_TOL), (dv, dv_p, BF16_TOL)))):
            if seq_len is not None and name != "flash_fwd":
                continue  # the backward always sees every key
            err = max((a.float() - b.float()).abs().max().item() for a, b, _ in pairs)
            row[name + "_max_abs_err"] = err
            errs[name] = max(errs[name], err)
            if not all(torch.allclose(a.float(), b.float(), rtol=tol, atol=tol)
                       for a, b, tol in pairs):
                raise AssertionError(f"{name} bf16 {(BH, S, dh)} window={window}: "
                                     f"max abs err {err}")
        if seq_len is not None:
            dead = seq_len - 1 + window
            if not (o[:, dead:].abs().max().item() == 0.0 and bool((L[:, dead:] <= -1e29).all())):
                raise AssertionError("flash_fwd bf16: fully-masked rows are not 0 with L = -1e30")
            row["fully_masked_rows_zero"] = True
        rows.append(row)

    BH, S, dh = path
    q, k, v, do = (torch.randn((BH, S, dh), device="cuda", generator=gen).to(bf16)
                   for _ in range(4))
    o, L = kflash.flash_fwd(q, k, v)
    D = (do.float() * o.float()).sum(-1)
    timing = {}
    x64 = [x.double() for x in (q, k, v, do, L, D)]
    # B1: the error of O; B2 and B3: of dQ, and of dK or dV (the larger)
    want = {"flash_fwd": (kflash.flash_fwd_plain(*x64[:3])[0],),
            "flash_bwd_dq": (kflash.flash_bwd_dq_plain(*x64),),
            "flash_bwd_dkv": kflash.flash_bwd_dkv_plain(*x64)}
    for name, w in want.items():
        def rel(fn):
            got = fn(q, k, v) if name == "flash_fwd" else fn(q, k, v, do, L, D)
            got = got[:1] if name == "flash_fwd" else got
            got = got if isinstance(got, tuple) else (got,)
            return max(float((x.double() - y).norm() / y.norm()) for x, y in zip(got, w))
        t = timing[name] = {"rel_err_f64": rel(getattr(kflash, name)),
                            "plain_rel_err_f64": rel(getattr(kflash, name + "_plain"))}
        if not t["rel_err_f64"] <= F64_ERR_FACTOR * t["plain_rel_err_f64"]:
            raise AssertionError(f"{name} bf16: relative error {t['rel_err_f64']} against "
                                 f"float64 exceeds {F64_ERR_FACTOR}x the plain version's "
                                 f"{t['plain_rel_err_f64']}")
    for name, fn, plain in (
            ("flash_fwd", lambda: kflash.flash_fwd(q, k, v),
             lambda: kflash.flash_fwd_plain(q, k, v)),
            ("flash_bwd_dq", lambda: kflash.flash_bwd_dq(q, k, v, do, L, D),
             lambda: kflash.flash_bwd_dq_plain(q, k, v, do, L, D)),
            ("flash_bwd_dkv", lambda: kflash.flash_bwd_dkv(q, k, v, do, L, D),
             lambda: kflash.flash_bwd_dkv_plain(q, k, v, do, L, D))):
        t = timing.setdefault(name, {})
        t["ms"], t["host_ms"] = time_ms(fn)
        t["plain_ms"], _ = time_ms(plain)
    for name, n in kflash.launched_blocks().items():
        timing[name]["blocks"] = n
    q4, k4, v4 = (x.reshape(1, BH, S, dh).clone().requires_grad_(True) for x in (q, k, v))
    with torch.no_grad():
        sdpa_fwd, _ = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.reshape(1, BH, S, dh)
    sdpa_bwd, _ = time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True))
    timing["flash_fwd"]["library_ms"] = sdpa_fwd
    timing["flash_bwd_dq"]["library_ms"] = timing["flash_bwd_dkv"]["library_ms"] = sdpa_bwd
    for name, (f_in, f_p, nbytes) in flash_work(BH, S, dh, elem=2).items():
        # every product at the bf16 rate: B1's QK^T and its P V in two bf16
        # passes (P split into hi and lo parts); B2 and B3 multiply bf16 P and dS
        t_ops = (f_in + 2 * f_p if name == "flash_fwd" else f_in + f_p) / peaks[3]
        t_bytes = nbytes / peaks[1]
        timing[name].update(bound_ms=1e3 * max(t_ops, t_bytes),
                            bound_by="operations" if t_ops >= t_bytes else "bytes")
    return rows, errs, timing


def check_schedule_grads(torch, cfg, K, M, rtol=1e-5):
    """The main path's correctness at full width: on one batch, the
    gradient of each SPMD schedule (through B1-B3) against the whole-model
    gradient of the sim path's dense forward, leaf by leaf, as
    ``||g - g_ref|| / ||g_ref||``. The CPU tests hold the same to 1e-5 at
    smoke size against the reference (tests/test_torch_spmd.py)."""
    from repro_torch.data import batches
    from repro_torch.engine.schedules import make_schedule_grad
    from repro_torch.engine.spmd import stack_stage_params, unstack_stage_params
    from repro_torch.models import Transformer, loss_fn, param_leaves

    cfg = cfg.replace(scan_layers=False)
    model = Transformer(cfg, device="cuda", seed=0)
    batch = next(batches(cfg, 8, 256, seed=0, device="cuda"))
    loss, _ = loss_fn(model, batch)
    leaves = param_leaves(model)
    ref = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    loss = loss.detach()
    stacked, shared = stack_stage_params({k: v.detach() for k, v in leaves.items()}, cfg, K)
    mbatch = {k: v.reshape(M, -1, v.shape[-1]) for k, v in batch.items()}
    out = {"phase": "spmd_gradients", "whole_model_loss": float(loss)}
    for schedule in SPMD_STEPS:
        kcfg = cfg.replace(use_kernels=True)
        l, (gs, gsh) = make_schedule_grad(kcfg, K, M, schedule)(stacked, shared, mbatch)
        g = unstack_stage_params(gs, gsh)
        rel = max(float((g[k] - ref[k]).norm() / ref[k].norm().clamp(min=1e-30)) for k in ref)
        out[schedule] = {"loss": float(l), "max_rel_grad_err": rel}
        if not (rel < rtol and abs(float(l) - float(loss)) < rtol * float(loss)):
            raise AssertionError(f"{schedule} gradient: max relative error {rel}, "
                                 f"loss {float(l)} vs {float(loss)}")
    return out


def check_bf16_dtypes(train, args, batch=None):
    """One more step of the bf16 path (a fresh trainer for ``args``, on
    ``batch`` or its stream's first) under the dtype check: every float the
    step computes is bfloat16 or float32, bfloat16 is among them, and the
    masters and optimizer state it reads and writes are float32."""
    from repro_torch.analysis import (
        BF16_COMPUTE_POLICY,
        check_dtype_policy,
        record_float_dtypes,
        state_leaves,
    )

    engine, data, _ = train.build(train.parse_args(args))
    state = engine.init_state()
    batch = next(data) if batch is None else batch
    (state, loss, _), seen = record_float_dtypes(engine.step, state, batch, 0)
    res = check_dtype_policy(seen, state_leaves((state.params, state.opt_state)),
                             BF16_COMPUTE_POLICY)
    if not (res.passed and math.isfinite(float(loss))):
        raise AssertionError(f"bf16 step: loss {float(loss)}, dtype check {res.to_json()}")
    return res.to_json()


def check_serve_decode(torch, cfg, tol=DECODE_TOL):
    """Full-width decode on the card in float32 compute: the logits decoded
    at the prompt's positions against ``forward_train``'s on the prompt,
    within the reference's consistency tolerance ``tol``. Beside it, the
    same ``forward_train`` on the CPU against the card's: the size of
    float32 roundoff between two summation orders at this width and depth.
    Then the same serving run in the config's own compute dtype. Reports
    tokens per second of both."""
    import copy

    from repro_torch.launch.serve_decode import serve
    from repro_torch.models import forward_train

    out = {}
    for dtype in ("float32", cfg.dtype):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = serve(cfg.replace(dtype=dtype), SERVE["batch"], SERVE["prompt_len"],
                    SERVE["gen_len"], torch.device("cuda"))
        row = {"dtype": dtype, "wall_s": time.perf_counter() - t0,
               "tokens_per_s": res["tokens_per_s"], "decode_s": res["seconds"],
               "generated_shape": list(res["generated"].shape),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if dtype == "float32":
            with torch.no_grad():
                full, _ = forward_train(res["model"], res["prompt"])
                on_cpu, _ = forward_train(copy.deepcopy(res["model"]).cpu(), res["prompt"].cpu())
            got = res["prompt_logits"]
            row["forward_train_card_vs_cpu_max_abs_err"] = float(
                (full.cpu() - on_cpu).abs().max())
            err = row["prefill_vs_forward_train_max_abs_err"] = float((got - full).abs().max())
            if not torch.allclose(got, full, rtol=tol, atol=tol):
                raise AssertionError(f"serve_decode: decoded prompt logits differ from "
                                     f"forward_train by {err}")
        if tuple(res["generated"].shape) != (SERVE["batch"], SERVE["gen_len"]) or not bool(
                ((res["generated"] >= 0) & (res["generated"] < cfg.vocab_size)).all()):
            raise AssertionError(f"serve_decode: generated {res['generated']}")
        out[dtype] = row
        del res
    return out


@contextlib.contextmanager
def swapped_config(arch, change, smoke_config=False):
    """For the duration, ``get_config`` of ``arch`` (its full config, or its
    ``--smoke`` one) passed through ``change``: what the launcher's flags
    cannot set, as the reference's launcher has no flag for it either."""
    import repro_torch.configs as configs

    real = configs.get_config

    def get_config(name, smoke=False):
        cfg = real(name, smoke)
        if smoke == smoke_config and name == arch:
            cfg = change(cfg)
        return cfg

    configs.get_config = get_config
    try:
        yield
    finally:
        configs.get_config = real


def smoke_attention(arch, **changes):
    """The launcher's ``--smoke`` config of ``arch`` with its attention
    changed: a head dim or a window that ``reduce_for_smoke`` does not give."""
    return swapped_config(
        arch, lambda c: c.replace(attention=dataclasses.replace(c.attention, **changes)),
        smoke_config=True)


def xlstm_cut():
    """The launcher's full xlstm_1_3b cut to ``XLSTM_LAYERS`` layers."""
    return swapped_config("xlstm_1_3b", lambda c: c.replace(num_layers=XLSTM_LAYERS))


def per_step(rows, counts, key_of):
    """Sum a per-launch measurement over one step's launch multiset."""
    by_key = {key_of(r): r for r in rows if "ms" in r}
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for key, n in counts.items():
        r = by_key[key]
        for f in total:
            if f in r:
                total[f] += n * r[f]
    return total


def zero_counts(kernels) -> None:
    for fn, attr in kernels.values():
        setattr(fn, attr, 0)


def read_counts(kernels):
    return {name: getattr(fn, attr) for name, (fn, attr) in kernels.items()}


@contextlib.contextmanager
def b5_in_place(calls):
    """Within: every call of B5's grouped entry must write each v' over its v
    (the returned v'_i are the v_i: the optimizer state keeps its storage);
    ``calls`` counts them."""
    from repro_torch.kernels import adam_step as kadam

    inner = kadam.adam_scale_grouped

    def check(gs, ms, vs, *args, **kw):
        steps, v_news = inner(gs, ms, vs, *args, **kw)
        if not all(vn is v for vn, v in zip(v_news, vs)):
            raise AssertionError("B5 on a training path wrote v' beside v, not over it")
        calls.append(len(vs))
        return steps, v_news

    kadam.adam_scale_grouped = check
    try:
        yield
    finally:
        kadam.adam_scale_grouped = inner


def run_path(train, torch, kernels, args, want):
    """Drive one path through the launcher with every launch count zeroed
    just before and read just after; check finite losses, the counts and
    that every B5 call wrote v' over v."""
    steps = int(args[args.index("--steps") + 1])
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    b5_calls = []
    t0 = time.perf_counter()
    with b5_in_place(b5_calls):
        result = train.main(args)
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    losses = result["losses"]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{' '.join(args)}: losses {losses}")
    if launches != want:
        raise AssertionError(f"{' '.join(args)}: kernel launches {launches}, expected {want}")
    step_s, data_s = result["step_s"], result["data_s"]
    tokens = result["tokens_per_step"]
    refresh = [t for t in range(steps) if t % 10 == 0]
    plain_steps = [s for t, s in enumerate(step_s) if t not in refresh] or step_s
    return {"args": " ".join(args), "losses": losses, "launches": launches,
            "b5_in_place_calls": len(b5_calls), "step_s": step_s, "data_s": data_s,
            "median_step_s": statistics.median(step_s),
            "median_step_s_no_refresh": statistics.median(plain_steps),
            "refresh_step_s": [step_s[t] for t in refresh],
            "median_data_s": statistics.median(data_s),
            "tokens_per_s_step": tokens / statistics.median(step_s),
            "tokens_per_s_wall": tokens * steps / wall,
            "wall_s": wall, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nest of dicts, lists and tuples: an engine
    state's parameters, optimizer state and delay queues, which its
    checkpoint holds."""
    from repro_torch.analysis import state_leaves

    return sum(x.numel() * x.element_size() for x in state_leaves(tree).values())


def reckon_sim(cfg, stages):
    """What a sim step of ``cfg`` on ``stages`` stages (basis rotation with
    the launcher's defaults, the kernels' grouped step) must hold, in bytes
    by kind, from the optimizer that the launcher builds, initialised over
    the model's meta-device parameters (nothing is allocated): float32
    masters and their gradients, Adam's m and v, the bases U, V, the grams
    L, R and the delay rings; and, beside them, the grouped rotation's
    transients at their peak (U^T [G, M] and [G, M] V both alive: four
    floats per rotated element). Activations and the updates are not
    counted."""
    from repro_torch.analysis import state_leaves
    from repro_torch.configs import OptimizerConfig
    from repro_torch.core.layout import build_layout
    from repro_torch.models import Transformer, param_leaves
    from repro_torch.optim.factory import build_optimizer

    cfg = cfg.replace(scan_layers=False)
    params = param_leaves(Transformer(cfg, device="meta", seed=None))
    opt = build_optimizer(OptimizerConfig(name="basis_rotation"), params, cfg,
                          num_stages=stages, use_kernels=True)
    kind = {"m": "adam", "v": "adam", "U": "bases", "V": "bases", "L": "grams", "R": "grams"}
    out = Counter()
    for path, x in state_leaves(opt.init(params)).items():
        parts = path.split("/")
        out[kind[parts[-1]] if parts[0] == "inner" else "delay_rings"] += (
            x.numel() * x.element_size())
    nparams = sum(p.numel() for p in params.values())
    out["masters"] = out["gradients"] = 4 * nparams
    rotated = sum(math.prod(pl.shape) for pl in build_layout(params, "bilateral") if pl.rotate)
    held = sum(out.values())
    return {"layers": cfg.num_layers, "params": nparams, "rotated_params": rotated,
            "bytes": dict(out), "held_bytes": held, "rotation_transient_bytes": 16 * rotated,
            "reckoned_peak_bytes": held + 16 * rotated}


def run_to_checkpoint(train, torch, kernels, args, cut, ckpt_dir, want):
    """First leg of a resume check: the launcher's trainer for ``args`` (its
    schedule built for all of their steps) runs steps 0..cut-1 and
    checkpoints at ``cut`` into ``ckpt_dir``. Refuses to start unless the
    disk holds twice the checkpoint's bytes (the resumed leg's final
    checkpoint is written before the first is collected)."""
    from repro_torch.engine import run_loop

    engine, data, loop_cfg = train.build(train.parse_args(args))
    held = [engine.init_state()]
    nbytes = tensor_bytes(held[0].params) + tensor_bytes(held[0].opt_state)
    disk = shutil.disk_usage(ckpt_dir)
    disk_line = {"path": ckpt_dir, "total": disk.total, "used": disk.used, "free": disk.free,
                 "state_bytes": nbytes}
    print(json.dumps({"disk_usage": disk_line}), flush=True)
    if disk.free < 2 * nbytes:
        raise AssertionError(f"{ckpt_dir}: {disk.free} bytes free, a checkpoint of {nbytes} "
                             f"bytes needs twice that")
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    t0 = time.perf_counter()
    _, losses, timings = run_loop(
        engine, data, dataclasses.replace(loop_cfg, steps=cut, ckpt_dir=ckpt_dir),
        state=held.pop())
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    if len(losses) != cut or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{' '.join(args)} to step {cut}: losses {losses}")
    if launches != want:
        raise AssertionError(f"{' '.join(args)} to step {cut}: kernel launches {launches}, "
                             f"expected {want}")
    ckpt_bytes = sum(f.stat().st_size for f in Path(ckpt_dir).iterdir())
    return {"losses": losses, "launches": launches, "state_bytes": nbytes,
            "ckpt_bytes": ckpt_bytes, "ckpt_files": sorted(f.name for f in Path(ckpt_dir).iterdir()),
            "snapshot_s": timings.ckpt_s, "write_s": timings.write_s,
            "median_step_s": statistics.median(timings.step_s), "wall_s": wall,
            "disk": disk_line, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def resume_from_checkpoint(train, torch, kernels, args, cut, ckpt_dir, want):
    """Second leg: a fresh trainer through the launcher with ``--ckpt-dir``,
    which resumes at ``cut`` (fast-forwarding the stream) and runs the rest.
    The stream's draws and the checkpoint load are timed by wrapping them."""
    from repro_torch import data as rdata
    from repro_torch.checkpoint import ckpt as rckpt

    draws, loads = [], []
    real_batches, real_load = rdata.batches, rckpt.load_checkpoint

    def timed_batches(*a, **kw):
        it = real_batches(*a, **kw)
        while True:
            t0 = time.perf_counter()
            b = next(it)
            draws.append(time.perf_counter() - t0)
            yield b

    def timed_load(path):
        t0 = time.perf_counter()
        out = real_load(path)
        loads.append(time.perf_counter() - t0)
        return out

    rdata.batches, rckpt.load_checkpoint = timed_batches, timed_load
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        t0 = time.perf_counter()
        result = train.main(args + ["--ckpt-dir", ckpt_dir])
        wall = time.perf_counter() - t0
        launches = read_counts(kernels)
    finally:
        rdata.batches, rckpt.load_checkpoint = real_batches, real_load
    losses = result["losses"]
    steps = int(args[args.index("--steps") + 1])
    if result["start_step"] != cut or len(losses) != steps - cut or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"{' '.join(args)} resumed at {result['start_step']}: "
                             f"losses {losses}")
    if launches != want:
        raise AssertionError(f"{' '.join(args)} resumed: kernel launches {launches}, "
                             f"expected {want}")
    return {"start_step": cut, "losses": losses, "launches": launches,
            "load_s": loads, "fast_forward_s": sum(draws[:cut]),
            "fast_forward_per_batch_s": draws[:cut], "final_snapshot_s": result["ckpt_s"],
            "final_write_s": result["write_s"], "median_step_s": statistics.median(result["step_s"]),
            "median_data_s": statistics.median(result["data_s"]), "wall_s": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def check_resume(train, torch, kernels, args, cut, want_per_step, uninterrupted):
    """Both legs in a temporary directory that is deleted after; the resumed
    losses against the uninterrupted run's (``uninterrupted``, same args)."""
    steps = int(args[args.index("--steps") + 1])
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        first = run_to_checkpoint(train, torch, kernels, args, cut, ckpt_dir,
                                  {k: cut * n for k, n in want_per_step.items()})
        second = resume_from_checkpoint(train, torch, kernels, args, cut, ckpt_dir,
                                        {k: (steps - cut) * n for k, n in want_per_step.items()})
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    diffs = [abs(a - b) for a, b in zip(first["losses"] + second["losses"], uninterrupted)]
    resumed_diff = max(diffs[cut:])
    if len(diffs) != steps or resumed_diff > RESUME_TOL:
        raise AssertionError(f"{' '.join(args)}: resumed losses {second['losses']} against "
                             f"{uninterrupted[cut:]} (max abs diff {resumed_diff})")
    return {"args": " ".join(args), "cut": cut, "uninterrupted_losses": uninterrupted,
            "max_abs_diff_resumed": resumed_diff, "max_abs_diff_first_leg": max(diffs[:cut]),
            "first_leg": first, "resumed_leg": second}


def run_baseline(train, torch, kernels, args, batch_list, want, first_loss=None):
    """One run through the launcher's trainer with the phase's batches in
    place of its stream; every launch count zeroed just before and read just
    after. Checks finite losses, the launches, and the first loss against
    ``first_loss`` (the same weights and batch, before any update) where one
    is given. For delay compensation also reports its weight queues' bytes."""
    from repro_torch.engine import run_loop

    steps = int(args[args.index("--steps") + 1])
    engine, _, loop_cfg = train.build(train.parse_args(args))
    held = [engine.init_state()]
    opt_state = held[0].opt_state
    param_q = tensor_bytes(opt_state["param_q"]) if "param_q" in opt_state else None
    del opt_state
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    t0 = time.perf_counter()
    _, losses, timings = run_loop(engine, iter(batch_list), loop_cfg, state=held.pop())
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{' '.join(args)}: losses {losses}")
    if launches != want:
        raise AssertionError(f"{' '.join(args)}: kernel launches {launches}, expected {want}")
    first_diff = None if first_loss is None else abs(losses[0] - first_loss)
    if first_diff is not None and first_diff > FIRST_LOSS_TOL:
        raise AssertionError(f"{' '.join(args)}: first loss {losses[0]} against {first_loss}")
    return {"losses": losses, "launches": launches, "first_loss_diff": first_diff,
            "step_s": timings.step_s, "median_step_s_no_refresh": statistics.median(
                timings.step_s[1:]), "wall_s": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            **({"param_q_bytes": param_q} if param_q is not None else {})}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import adam_step as kadam
    from repro_torch.kernels import build
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import matmul as kmm
    from repro_torch.launch import profile_step, train
    # one step's four grouped B4 launches and B5's leaves, per path
    from repro_torch.launch.bench_matmul import path_groups

    # each kernel's launch count: (wrapper, attribute); B1-B3 count their
    # float32 and bfloat16 entry points apart
    kernels = {"flash_fwd": (kflash.flash_fwd, "launches"),
               "flash_bwd_dq": (kflash.flash_bwd_dq, "launches"),
               "flash_bwd_dkv": (kflash.flash_bwd_dkv, "launches"),
               "flash_fwd_bf16": (kflash.flash_fwd, "launches_bf16"),
               "flash_bwd_dq_bf16": (kflash.flash_bwd_dq, "launches_bf16"),
               "flash_bwd_dkv_bf16": (kflash.flash_bwd_dkv, "launches_bf16"),
               "matmul": (kmm.matmul, "launches"), "adam_scale": (kadam.adam_scale, "launches")}
    none = {k: 0 for k in kernels}
    OUT_DIR.mkdir(exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    part, peaks = card_peaks(name)

    # phase 1: the card and the build
    lib = build.load_library()
    (OUT_DIR / "nvcc_log.txt").write_text(lib.log)
    adam_ptxas = ptxas_report(lib.log, "adam_scale_grouped_kernel") if lib.log else None
    if adam_ptxas is not None and (not adam_ptxas or any(
            r["spill_stores"] != 0 for r in adam_ptxas.values())):
        raise AssertionError(f"adam_scale_grouped_kernel: ptxas report {adam_ptxas}")
    # B4's four instantiations (one per pair of transpose flags): no spills
    mm_ptxas = ptxas_report(lib.log, "grouped_tf32x3_kernel") if lib.log else None
    if mm_ptxas is not None and (len(mm_ptxas) != 4 or any(
            r["spill_stores"] != 0 for r in mm_ptxas.values())):
        raise AssertionError(f"grouped_tf32x3_kernel: ptxas report {mm_ptxas}")
    # B1-B3, float32 and bf16 entry points at every head width: no spills
    flash_ptxas = ptxas_report(lib.log, "flash_") if lib.log else None
    if flash_ptxas is not None and (len(flash_ptxas) != FLASH_INSTANTIATIONS or any(
            r["spill_stores"] != 0 for r in flash_ptxas.values())):
        raise AssertionError(f"flash kernels: ptxas report {flash_ptxas}")
    emit({"phase": "device", "nvidia_smi": smi, "kind": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks_for": part,
          "f32_peak_tflops": peaks[0] / 1e12, "mem_tb_s": peaks[1] / 1e12,
          "tf32_peak_tflops": peaks[2] / 1e12,
          "build_s": lib.build_seconds, "library": lib.path.name,
          "adam_ptxas": adam_ptxas, "matmul_ptxas": mm_ptxas,
          "flash_ptxas": None if flash_ptxas is None else {
              flash_entry(k): v for k, v in flash_ptxas.items()}})

    # phase 2: each kernel against its plain version. B4 per shape as a
    # group of one, then as the grouped launches of the sim and SPMD paths
    # (K stages of L / K layers each)
    cfg = get_config("paper_95m")
    K, M, L = 8, 8, cfg.num_layers
    (groups, adam_leaves), (sgroups, sadam_leaves) = path_groups(cfg), path_groups(cfg, K)
    # the xLSTM sim path's 39 rotated leaves: 8192-, 4096- and 2662-sided
    # bases, the 3-D w_r as one problem of batch 4
    xcfg = get_config("xlstm_1_3b").replace(num_layers=XLSTM_LAYERS)
    xgroups, xadam_leaves = path_groups(xcfg)
    # paper_1b's sim path: 144 rotated leaves, 1728- and 6912-sided bases
    pcfg = get_config("paper_1b")
    pgroups, padam_leaves = path_groups(pcfg)
    mm_counts, smm_counts = product_counts(groups), product_counts(sgroups)
    check_s = {}  # host seconds of each of phase 2's checks

    def timed(key, check, *args):
        t0 = time.perf_counter()
        out = check(*args)
        check_s[key] = time.perf_counter() - t0
        return out

    mm_rows, mm_err = timed("matmul", check_matmul, torch, kmm, peaks)
    grp_rows, grp_err = timed("matmul_grouped", check_matmul_groups, torch, kmm, {
        "sim": groups, "spmd": sgroups, "xlstm_sim": xgroups, "paper_1b_sim": pgroups}, peaks)
    mm_err = max(mm_err, grp_err)
    adam_rows, adam_err = timed("adam", check_adam, torch, kadam)
    agrp_rows, agrp_err = timed("adam_grouped", check_adam_groups, torch, kadam, {
        "sim": adam_leaves, "spmd": sadam_leaves, "xlstm_sim": xadam_leaves,
        "paper_1b_sim": padam_leaves}, peaks)
    adam_err = max(adam_err, agrp_err)
    flash_rows, flash_errs, flash_t = timed("flash", check_flash, torch, kflash, peaks)
    bf16_rows, bf16_errs, bf16_t = timed("flash_bf16", check_flash_bf16, torch, kflash, peaks)
    # head dim 128 at qwen3_0_6b's path shape, both entry points
    h128_rows, h128_errs, h128_t = timed("flash_dh128", check_flash, torch, kflash, peaks,
                                         QWEN3_FLASH_PATH)
    h128b_rows, h128b_errs, h128b_t = timed("flash_bf16_dh128", check_flash_bf16, torch,
                                            kflash, peaks, QWEN3_FLASH_PATH)
    # the bf16 B1, B2 and B3 (wgmma) at both path shapes: their time beside
    # SDPA's bf16 forward or backward, ptxas's registers and spills, and their
    # error against float64, each beside the old kernels', and the host ns to
    # encode one launch's TMA tensor maps
    def bf16_ptxas(name, dh):
        return None if flash_ptxas is None else {
            flash_entry(k): v for k, v in flash_ptxas.items()
            if f"{name}_bf16_kernelILi{dh}E" in k}

    bf16_fwd, bf16_bwd = {}, {}
    for path, t in ((FLASH_PATH, bf16_t), (QWEN3_FLASH_PATH, h128b_t)):
        f = t["flash_fwd"]
        x = torch.empty(path, dtype=torch.bfloat16, device="cuda")
        bf16_fwd[str(path)] = {
            "us": 1e3 * f["ms"], "sdpa_fwd_us": 1e3 * f["library_ms"], "blocks": f["blocks"],
            "bound_us": 1e3 * f["bound_ms"], "rel_err_f64": f["rel_err_f64"],
            "plain_rel_err_f64": f["plain_rel_err_f64"],
            "ptxas": bf16_ptxas("flash_fwd", path[2]), "old": OLD_BF16_FWD[path],
            "tensor_maps_ns": lib.lib.rbr_flash_fwd_bf16_maps_ns(x.data_ptr(), *path, 1000)}
        bf16_bwd[str(path)] = {name: {
            "us": 1e3 * t[name]["ms"], "sdpa_bwd_us": 1e3 * t[name]["library_ms"],
            "blocks": t[name]["blocks"], "bound_us": 1e3 * t[name]["bound_ms"],
            "rel_err_f64": t[name]["rel_err_f64"],
            "plain_rel_err_f64": t[name]["plain_rel_err_f64"],
            "ptxas": bf16_ptxas(name, path[2]),
            "old": OLD_BF16_BWD[path][name]} for name in ("flash_bwd_dq", "flash_bwd_dkv")}
        bf16_bwd[str(path)]["b2_plus_b3_us"] = sum(
            bf16_bwd[str(path)][name]["us"] for name in ("flash_bwd_dq", "flash_bwd_dkv"))
        bf16_bwd[str(path)]["tensor_maps_ns"] = lib.lib.rbr_flash_bwd_bf16_maps_ns(
            x.data_ptr(), *path, 1000)
    (OUT_DIR / "chip_smoke_kernels.json").write_text(json.dumps(
        {"matmul": mm_rows, "matmul_grouped": grp_rows, "adam_scale": adam_rows,
         "adam_scale_grouped": agrp_rows,
         "flash": flash_rows, "flash_timing_per_launch": flash_t,
         "flash_bf16": bf16_rows, "flash_bf16_timing_per_launch": bf16_t,
         "flash_dh128": h128_rows, "flash_dh128_timing_per_launch": h128_t,
         "flash_bf16_dh128": h128b_rows, "flash_bf16_dh128_timing_per_launch": h128b_t},
        indent=1))
    emit({"phase": "kernels", "check_s": check_s, "matmul_cases": len(mm_rows) + len(grp_rows),
          "matmul_max_abs_err": mm_err,
          "matmul_grouped_ms": {r["group"]: r["ms"] for r in grp_rows if "ms" in r},
          "adam_cases": len(adam_rows), "adam_max_abs_err": adam_err,
          "adam_max_rel_err": max(r["max_rel_err"] for r in adam_rows),
          "adam_bitwise_equal": all(r["bitwise_equal"] for r in adam_rows),
          "adam_grouped": {r["group"]: {k: r[k] for k in (
              "leaves", "ms", "inplace_ms", "per_leaf_ms", "plain_ms",
              "bound_ms", "bound_share", "inplace_bound_share", "host_ms", "host_inplace_ms",
              "host_per_leaf_ms", "leaves_per_run_per_leaf_ms", "leaves_per_run_plain_ms")
              if k in r} for r in agrp_rows},
          "flash_cases": len(flash_rows), "flash_max_abs_err": flash_errs,
          "flash_ms_per_launch": {k: {f: t[f] for f in ("ms", "plain_ms", "library_ms",
                                                        "bound_ms", "host_ms")}
                                  for k, t in flash_t.items()},
          "flash_blocks": {k: t["blocks"] for k, t in flash_t.items()},
          "flash_bwd_rel_err_f64": {k: {f: t[f] for f in ("rel_err_f64", "plain_rel_err_f64")}
                                    for k, t in flash_t.items() if "rel_err_f64" in t},
          "flash_bitwise_repeat": {k: all(r[k + "_bitwise_repeat"] for r in flash_rows)
                                   for k in flash_t},
          "flash_bf16_cases": len(bf16_rows), "flash_bf16_max_abs_err": bf16_errs,
          "flash_bf16_ms_per_launch": {k: {f: t[f] for f in (
              "ms", "plain_ms", "library_ms", "bound_ms", "host_ms")} for k, t in bf16_t.items()},
          "flash_bf16_blocks": {k: t["blocks"] for k, t in bf16_t.items()},
          "flash_bf16_rel_err_f64": {
              k: {f: t[f] for f in ("rel_err_f64", "plain_rel_err_f64")}
              for k, t in bf16_t.items() if "rel_err_f64" in t},
          "flash_bf16_bitwise_repeat": {k: all(r[k + "_bitwise_repeat"] for r in bf16_rows)
                                        for k in bf16_t},
          "flash_bf16_fwd": bf16_fwd, "flash_bf16_bwd": bf16_bwd,
          **{f"flash{tag}_dh128": {
              "cases": len(r), "max_abs_err": e, "blocks": {k: x["blocks"] for k, x in t.items()},
              "ms_per_launch": {k: {f: x[f] for f in ("ms", "plain_ms", "library_ms",
                                                      "bound_ms", "host_ms")}
                                for k, x in t.items()},
              "rel_err_f64": {k: {f: x[f] for f in ("rel_err_f64", "plain_rel_err_f64")}
                              for k, x in t.items() if "rel_err_f64" in x},
              "bitwise_repeat": all(row[k + "_bitwise_repeat"] for row in r for k in t)}
             for tag, r, e, t in (("", h128_rows, h128_errs, h128_t),
                                  ("_bf16", h128b_rows, h128b_errs, h128b_t))}})

    # phase 3: the sim path
    steps = int(MAIN_ARGS[MAIN_ARGS.index("--steps") + 1])
    want = {k: 0 for k in kernels}
    adam_per_step = -(-len(adam_leaves) // kadam.MAX_LEAVES)  # one grouped launch
    sadam_per_step = -(-len(sadam_leaves) // kadam.MAX_LEAVES)
    want.update(matmul=steps * sum(1 for g in groups if g), adam_scale=steps * adam_per_step)
    sim = run_path(train, torch, kernels, MAIN_ARGS, want)
    emit({"phase": "main_path", **sim})

    # phase 4: the SPMD path, both schedules; M microbatches over L layers
    emit(check_schedule_grads(torch, cfg, K, M))
    torch.cuda.empty_cache()
    spmd = {}
    for schedule, n in SPMD_STEPS.items():
        args = SPMD_ARGS + ["--schedule", schedule, "--steps", str(n)]
        fwd = 2 if schedule == "1f1b" else 1  # 1F1B recomputes in its backward
        want = {**none, "flash_fwd": n * fwd * M * L, "flash_bwd_dq": n * M * L,
                "flash_bwd_dkv": n * M * L, "matmul": n * sum(1 for g in sgroups if g),
                "adam_scale": n * sadam_per_step}
        spmd[schedule] = run_path(train, torch, kernels, args, want)
        emit({"phase": f"spmd_{schedule}", **spmd[schedule]})

    # phase 4, bf16: the 1F1B path under the bf16_compute policy; B1-B3 through
    # their bf16 entry points only, B4 and B5 on the float32 gradients and state
    torch.cuda.empty_cache()
    bf16_args = SPMD_ARGS + ["--schedule", "1f1b", "--steps", str(BF16_STEPS),
                             "--precision", "bf16"]
    n = BF16_STEPS
    spmd_bf16 = run_path(train, torch, kernels, bf16_args, {
        **none, "flash_fwd_bf16": n * 2 * M * L, "flash_bwd_dq_bf16": n * M * L,
        "flash_bwd_dkv_bf16": n * M * L, "matmul": n * sum(1 for g in sgroups if g),
        "adam_scale": n * sadam_per_step})
    torch.cuda.empty_cache()
    spmd_bf16["dtype_check"] = check_bf16_dtypes(train, bf16_args)
    emit({"phase": "spmd_bf16", **spmd_bf16})

    # phase 4, continued: the resume paths, then the sim staleness modes
    sim_per_step = {k: 0 for k in kernels}
    sim_per_step.update(matmul=sum(1 for g in groups if g), adam_scale=adam_per_step)
    torch.cuda.empty_cache()
    resume_sim = check_resume(train, torch, kernels, MAIN_ARGS, RESUME_CUT["sim"], sim_per_step,
                              sim["losses"])
    emit({"phase": "resume_sim", **resume_sim})
    torch.cuda.empty_cache()
    fd_args = SPMD_ARGS + ["--schedule", "fill_drain", "--steps", str(SPMD_STEPS["fill_drain"])]
    spmd_per_step = {**none, "flash_fwd": M * L, "flash_bwd_dq": M * L,
                     "flash_bwd_dkv": M * L, "matmul": sum(1 for g in sgroups if g),
                     "adam_scale": sadam_per_step}
    resume_spmd = check_resume(train, torch, kernels, fd_args, RESUME_CUT["spmd"],
                               spmd_per_step, spmd["fill_drain"]["losses"])
    emit({"phase": "resume_spmd", **resume_spmd})
    modes = {}
    for mode in ("--no-stash", "--weight-prediction"):
        torch.cuda.empty_cache()
        args = list(MAIN_ARGS)
        args[args.index("--steps") + 1] = str(MODE_STEPS)
        modes[mode] = run_path(train, torch, kernels, args + [mode],
                               {k: MODE_STEPS * n for k, n in sim_per_step.items()})
    emit({"phase": "sim_modes", **modes})

    # the paper's baselines: one list of batches for every run (host sampling
    # costs seconds a batch), the sim path and the SPMD 1F1B path at full
    # width. B4 and B5 belong to basis rotation alone; B1-B3 run in every
    # SPMD attention call
    from itertools import islice

    from repro_torch.data import batches as data_batches

    t_phase = time.perf_counter()
    batch_list = list(islice(data_batches(cfg, 8, 256, seed=0, device="cuda"),
                             max(BASELINE_STEPS.values())))
    sample_s = time.perf_counter() - t_phase
    baselines = {"sim": {}, "spmd_1f1b": {}}
    for opt in BASELINES_SIM:
        torch.cuda.empty_cache()
        args = list(MAIN_ARGS)
        args[args.index("--optimizer") + 1] = opt
        args[args.index("--steps") + 1] = str(BASELINE_STEPS["sim"])
        baselines["sim"][opt] = run_baseline(train, torch, kernels, args, batch_list,
                                             none, sim["losses"][0])
    n = BASELINE_STEPS["spmd"]
    for opt in BASELINES_SPMD:
        torch.cuda.empty_cache()
        args = SPMD_ARGS + ["--schedule", "1f1b", "--steps", str(n)]
        args[args.index("--optimizer") + 1] = opt
        want = {**none, "flash_fwd": n * 2 * M * L, "flash_bwd_dq": n * M * L,
                "flash_bwd_dkv": n * M * L}
        baselines["spmd_1f1b"][opt] = run_baseline(train, torch, kernels, args, batch_list,
                                                   want, spmd["1f1b"]["losses"][0])
    emit({"phase": "baselines", "sample_s": sample_s,
          "phase_s": time.perf_counter() - t_phase, **baselines})

    # qwen3_0_6b at full width through the launcher's trainer, float32 then
    # bf16: B1-B3 at head dim 128 in the entry point the policy picks
    qcfg = get_config("qwen3_0_6b")
    qL, qM = qcfg.num_layers, int(CATALOG_ARGS[CATALOG_ARGS.index("--microbatches") + 1])
    qK = int(CATALOG_ARGS[CATALOG_ARGS.index("--stages") + 1])
    qgroups, qleaves = path_groups(qcfg, qK)
    batch_list = None  # the baselines' batches
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    batch_list = list(islice(data_batches(qcfg, 8, 256, seed=0, device="cuda"), CATALOG_STEPS))
    catalog = {"sample_s": time.perf_counter() - t_phase}
    catalog["data_s_per_batch"] = catalog["sample_s"] / CATALOG_STEPS
    n = CATALOG_STEPS
    for precision, sfx in (("f32", ""), ("bf16", "_bf16")):
        torch.cuda.empty_cache()
        args = CATALOG_ARGS + ["--steps", str(n), "--precision", precision]
        want = {**none, "flash_fwd" + sfx: n * 2 * qM * qL, "flash_bwd_dq" + sfx: n * qM * qL,
                "flash_bwd_dkv" + sfx: n * qM * qL,
                "matmul": n * sum(1 for g in qgroups if g),
                "adam_scale": n * -(-len(qleaves) // kadam.MAX_LEAVES)}
        run = run_baseline(train, torch, kernels, args, batch_list, want)
        run["refresh_step_s"] = run["step_s"][0]
        catalog[precision] = run
    torch.cuda.empty_cache()
    catalog["bf16"]["dtype_check"] = check_bf16_dtypes(
        train, CATALOG_ARGS + ["--steps", "1", "--precision", "bf16"], batch_list[0])
    catalog["first_loss_f32_minus_bf16"] = catalog["f32"]["losses"][0] - \
        catalog["bf16"]["losses"][0]
    catalog["phase_s"] = time.perf_counter() - t_phase
    del batch_list
    emit({"phase": "catalog_1f1b", **catalog})

    torch.cuda.empty_cache()
    serving = check_serve_decode(torch, qcfg)
    emit({"phase": "serve_decode", "arch": qcfg.name, **SERVE, **serving})

    # xlstm_1_3b at full width, one superblock deep, on the sim path: B4 and B5
    # on its 39 rotated leaves, B1-B3 never (no attention); then where the
    # step's time goes (profile_step over two steps after a refresh step)
    n = int(XLSTM_ARGS[XLSTM_ARGS.index("--steps") + 1])
    torch.cuda.empty_cache()
    with xlstm_cut():
        xsim = run_path(train, torch, kernels, XLSTM_ARGS, {
            **none, "matmul": n * sum(1 for g in xgroups if g),
            "adam_scale": n * -(-len(xadam_leaves) // kadam.MAX_LEAVES)})
        emit({"phase": "xlstm_sim", "layers": XLSTM_LAYERS, **xsim})
        torch.cuda.empty_cache()
        profile_step.main(XLSTM_ARGS + ["--warmup", "1", "--profile-steps", "2"])
    torch.cuda.empty_cache()
    xserving = check_serve_decode(torch, xcfg, XLSTM_DECODE_TOL)
    emit({"phase": "serve_decode_xlstm", "arch": xcfg.name, "layers": XLSTM_LAYERS, **SERVE,
          **xserving})

    # paper_1b, the abstract's 1B model, at full width on the sim path. The
    # reckoning comes first: the layers are cut (never the widths, and in
    # whole layers per stage) only if the state the step holds and the
    # rotation's transients would take more than 90% of the card, leaving
    # the rest to activations, updates and the allocator
    total = torch.cuda.get_device_properties(0).total_memory
    layers, K1b = pcfg.num_layers, int(PAPER_1B_ARGS[PAPER_1B_ARGS.index("--stages") + 1])
    reckon = reckon_sim(pcfg, K1b)
    while reckon["reckoned_peak_bytes"] > 0.9 * total and layers > K1b:
        layers -= K1b
        reckon = reckon_sim(pcfg.replace(num_layers=layers), K1b)
    emit({"phase": "paper_1b_reckoning", "card_bytes": total, "layers": layers,
          "layers_full": pcfg.num_layers, **reckon})
    n = int(PAPER_1B_ARGS[PAPER_1B_ARGS.index("--steps") + 1])
    torch.cuda.empty_cache()
    with (swapped_config("paper_1b", lambda c: c.replace(num_layers=layers))
          if layers != pcfg.num_layers else contextlib.nullcontext()):
        p1b = run_path(train, torch, kernels, PAPER_1B_ARGS, {
            **none, "matmul": n * sum(1 for g in pgroups if g),
            "adam_scale": n * -(-len(padam_leaves) // kadam.MAX_LEAVES)})
    p1b["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    p1b["reserved_headroom_gb"] = (total - torch.cuda.max_memory_reserved()) / 1e9
    p1b["gate_gb"] = 0.9 * total / 1e9
    p1b["reckoned_peak_gb"] = reckon["reckoned_peak_bytes"] / 1e9
    p1b["reckoned_gb"] = {k: v / 1e9 for k, v in reckon["bytes"].items()}
    p1b["launches_per_step"] = {k: v / n for k, v in p1b["launches"].items()}
    emit({"phase": "paper_1b_sim", "layers": layers, **p1b})

    # the earlier paths' peaks against theirs before the state was updated in place
    peaks_now = {"main_path": sim["peak_mem_gb"], "spmd_1f1b": spmd["1f1b"]["peak_mem_gb"],
                 "catalog_1f1b": max(catalog[p]["peak_mem_gb"] for p in ("f32", "bf16")),
                 "xlstm_sim": xsim["peak_mem_gb"]}
    emit({"phase": "peaks", **{k: {"peak_gb": v, "before_gb": EARLIER_PEAKS_GB[k],
                                   "fell_gb": EARLIER_PEAKS_GB[k] - v}
                               for k, v in peaks_now.items()}})
    grown = {k: v for k, v in peaks_now.items() if v > EARLIER_PEAKS_GB[k]}
    if grown:
        raise AssertionError(f"peaks above their earlier values {EARLIER_PEAKS_GB}: {grown}")

    # phase 5: the reduced model on the card against the CPU, same seed.
    # Adam has no QR: the devices differ only in float32 summation order
    # (measured ~1e-6 apart). Basis rotation: the refresh's QR of
    # rank-deficient grams fixes the basis past the rank by roundoff alone,
    # so the runs are held to the reference's own tolerance for two
    # implementations of this step (tests/test_engine.py:437-438).
    for backend in (["--backend", "sim"], ["--backend", "spmd", "--schedule", "1f1b"],
                    ["--backend", "spmd", "--schedule", "fill_drain"],
                    ["--backend", "sim", "--no-stash"],
                    ["--backend", "sim", "--weight-prediction"]):
        for opt, first2_tol, all_tol in ((["--optimizer", "adam"], 1e-4, 1e-4),
                                         (["--use-kernels"], 2e-3, 5e-2)):
            args = SMOKE_ARGS + backend + opt
            gpu = train.main(args)["losses"]
            cpu = train.main(args + ["--device", "cpu"])["losses"]
            diffs = [abs(a - b) for a, b in zip(gpu, cpu)]
            if not (len(diffs) == len(cpu) and max(diffs[:2]) < first2_tol
                    and max(diffs) < all_tol):
                raise AssertionError(f"{args}: cuda vs cpu losses differ: {gpu} vs {cpu}")
            emit({"phase": "cuda_vs_cpu", "args": " ".join(args), "cuda": gpu, "cpu": cpu,
                  "max_diff_first2": max(diffs[:2]), "max_diff": max(diffs)})
    for backend in (["--backend", "sim"], ["--backend", "spmd", "--schedule", "1f1b"]):
        for opt in BASELINES_SIM:
            all_tol = 1e-3 if opt in NEWTON_SCHULZ else 1e-4
            args = SMOKE_ARGS + backend + ["--optimizer", opt, "--use-kernels"]
            gpu = train.main(args)["losses"]
            cpu = train.main(args + ["--device", "cpu"])["losses"]
            diffs = [abs(a - b) for a, b in zip(gpu, cpu)]
            if not (len(diffs) == len(cpu) and max(diffs[:2]) < 1e-4 and max(diffs) < all_tol):
                raise AssertionError(f"{args}: cuda vs cpu losses differ: {gpu} vs {cpu}")
            emit({"phase": "cuda_vs_cpu", "args": " ".join(args), "cuda": gpu, "cpu": cpu,
                  "max_diff_first2": max(diffs[:2]), "max_diff": max(diffs)})
    # the public architectures at smoke size: qwen3_0_6b on 1F1B at head dim
    # 128 (the B1-B3 instantiation of its full config), qwen1_5_0_5b on the
    # sim path (qkv_bias), phi4_mini_3_8b_swa on 1F1B with a window of 16 of
    # the 32-token sequences, and xlstm_1_3b (an mLSTM and an sLSTM block) on
    # the sim path
    for arch, backend, change in (
            ("qwen3_0_6b", ["--backend", "spmd", "--schedule", "1f1b"], {"head_dim": 128}),
            ("qwen1_5_0_5b", ["--backend", "sim"], {}),
            ("phi4_mini_3_8b_swa", ["--backend", "spmd", "--schedule", "1f1b"],
             {"window": 16}),
            ("xlstm_1_3b", ["--backend", "sim"], {})):
        for opt, first2_tol, all_tol in ((["--optimizer", "adam"], 1e-4, 1e-4),
                                         (["--use-kernels"], 2e-3, 5e-2)):
            args = SMOKE_ARGS + ["--arch", arch] + backend + opt
            with smoke_attention(arch, **change):
                gpu = train.main(args)["losses"]
                cpu = train.main(args + ["--device", "cpu"])["losses"]
            diffs = [abs(a - b) for a, b in zip(gpu, cpu)]
            if not (len(diffs) == len(cpu) and max(diffs[:2]) < first2_tol
                    and max(diffs) < all_tol):
                raise AssertionError(f"{args} {change}: cuda vs cpu losses differ: "
                                     f"{gpu} vs {cpu}")
            emit({"phase": "cuda_vs_cpu", "args": " ".join(args), "attention": change,
                  "cuda": gpu, "cpu": cpu, "max_diff_first2": max(diffs[:2]),
                  "max_diff": max(diffs)})
    # bf16: the card's cuBLAS and the CPU's products round to bf16 at other
    # places, as two implementations of a bf16 step do (the CPU tests hold the
    # port to the reference at 1e-2 on the first loss, 3e-2 on all)
    args = SMOKE_ARGS + ["--backend", "spmd", "--schedule", "1f1b", "--precision", "bf16",
                         "--use-kernels"]
    gpu = train.main(args)["losses"]
    cpu = train.main(args + ["--device", "cpu"])["losses"]
    diffs = [abs(a - b) for a, b in zip(gpu, cpu)]
    if not (len(diffs) == len(cpu) and diffs[0] < 1e-2 and max(diffs) < 5e-2):
        raise AssertionError(f"{args}: cuda vs cpu losses differ: {gpu} vs {cpu}")
    emit({"phase": "cuda_vs_cpu", "args": " ".join(args), "cuda": gpu, "cpu": cpu,
          "max_diff_first": diffs[0], "max_diff": max(diffs)})

    # the kernel table. B4 and B5: per training step of the sim path (B4: its
    # four grouped launches; the plain and library times summed per product
    # over the step's products; B5: its grouped launch over the step's
    # leaves, cold, with the per-leaf sequence beside it); B1-B3: per
    # training step of the SPMD 1F1B path (launches per step times the
    # per-launch time at the path shape).
    # Bounds: B4 and B1-B3 on the tensor route (3xTF32), with the float32
    # FMA route beside them; B5 as it runs, on the FMA pipes.
    shape_key = lambda r: (*r["shape"], r["trans_a"], r["trans_b"])  # noqa: E731
    mm_tot = per_step(mm_rows, mm_counts, shape_key)
    smm_tot = per_step(mm_rows, smm_counts, shape_key)
    grouped = {path: {f: sum(r[f] for r in grp_rows if r["group"].startswith(path + "/"))
                      for f in ("ms", "plain_ms", "library_ms")}
               for path in ("sim", "spmd", "xlstm_sim", "paper_1b_sim")}
    b5_step = {r["group"]: r for r in agrp_rows}
    mm_bound, mm_bound_f32, mm_by = bounds(*mm_work([p for g in groups for p in g]), peaks,
                                           TF32_PASSES)
    xmm_bound, xmm_bound_f32, xmm_by = bounds(*mm_work([p for g in xgroups for p in g]), peaks,
                                              TF32_PASSES)
    pmm_bound, pmm_bound_f32, pmm_by = bounds(*mm_work([p for g in pgroups for p in g]), peaks,
                                              TF32_PASSES)

    def adam_bound(leaves):  # (least ms, what bounds it) of B5 on the FMA pipes
        nbytes = sum(20.0 * math.prod(sh) for sh in leaves)
        flops = sum(10.0 * math.prod(sh) for sh in leaves)
        return bounds(flops, nbytes, peaks)[1], (
            "operations" if flops / peaks[0] >= nbytes / peaks[1] else "bytes")

    b5_bound, b5_by = adam_bound(adam_leaves)

    rows = [{
        "name": "matmul", "route": "cuda", "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:30", "launches": sim["launches"]["matmul"],
        "max_abs_err": mm_err, "ms": grouped["sim"]["ms"], "plain_ms": grouped["sim"]["plain_ms"],
        "bound_ms": mm_bound, "bound_by": mm_by, "library_ms": mm_tot["library_ms"],
        "spmd_ms": grouped["spmd"]["ms"],
        "spmd_plain_ms": grouped["spmd"]["plain_ms"], "spmd_library_ms": smm_tot["library_ms"],
        "spmd_launches_1f1b": spmd["1f1b"]["launches"]["matmul"],
        "xlstm_launches": xsim["launches"]["matmul"], "xlstm_ms": grouped["xlstm_sim"]["ms"],
        "xlstm_plain_ms": grouped["xlstm_sim"]["plain_ms"],
        "xlstm_library_ms": grouped["xlstm_sim"]["library_ms"], "xlstm_bound_ms": xmm_bound,
        "xlstm_bound_by": xmm_by, "paper_1b_launches": p1b["launches"]["matmul"],
        "paper_1b_ms": grouped["paper_1b_sim"]["ms"],
        "paper_1b_plain_ms": grouped["paper_1b_sim"]["plain_ms"],
        "paper_1b_library_ms": grouped["paper_1b_sim"]["library_ms"],
        "paper_1b_bound_ms": pmm_bound, "paper_1b_bound_by": pmm_by,
    }, {
        "name": "adam_scale", "route": "cuda", "source": "src/repro_torch/kernels/csrc/adam_step.cu",
        "replaces": "src/repro/kernels/adam_step.py:28", "launches": sim["launches"]["adam_scale"],
        "max_abs_err": adam_err, "ms": b5_step["sim"]["ms"],
        "per_leaf_ms": b5_step["sim"]["per_leaf_ms"], "plain_ms": b5_step["sim"]["plain_ms"],
        "bound_ms": b5_bound, "bound_by": b5_by,
        "library_ms": None, "spmd_ms": b5_step["spmd"]["ms"],
        "spmd_per_leaf_ms": b5_step["spmd"]["per_leaf_ms"],
        "spmd_plain_ms": b5_step["spmd"]["plain_ms"],
        "spmd_launches_1f1b": spmd["1f1b"]["launches"]["adam_scale"],
        "xlstm_launches": xsim["launches"]["adam_scale"], "xlstm_ms": b5_step["xlstm_sim"]["ms"],
        "xlstm_per_leaf_ms": b5_step["xlstm_sim"]["per_leaf_ms"],
        "xlstm_plain_ms": b5_step["xlstm_sim"]["plain_ms"],
        "xlstm_bound_ms": adam_bound(xadam_leaves)[0],
        "paper_1b_launches": p1b["launches"]["adam_scale"], "paper_1b_ms": b5_step["paper_1b_sim"]["ms"],
        "paper_1b_per_leaf_ms": b5_step["paper_1b_sim"]["per_leaf_ms"],
        "paper_1b_plain_ms": b5_step["paper_1b_sim"]["plain_ms"],
        "paper_1b_bound_ms": adam_bound(padam_leaves)[0],
    }]
    onef = spmd["1f1b"]
    # computed, so kept off the kernels line
    bound_fp32 = {"matmul": mm_bound_f32, "matmul_xlstm": xmm_bound_f32,
                  "matmul_paper_1b": pmm_bound_f32}
    for kname, src, replaces in (
        ("flash_fwd", "src/repro_torch/kernels/csrc/flash_fwd.cu",
         "src/repro/kernels/flash.py:80"),
        ("flash_bwd_dq", "src/repro_torch/kernels/csrc/flash_bwd.cu",
         "src/repro/kernels/flash.py:162"),
        ("flash_bwd_dkv", "src/repro_torch/kernels/csrc/flash_bwd.cu",
         "src/repro/kernels/flash.py:196"),
    ):
        per = onef["launches"][kname] / SPMD_STEPS["1f1b"]
        t = flash_t[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": onef["launches"][kname], "max_abs_err": flash_errs[kname],
            "ms": per * t["ms"], "plain_ms": per * t["plain_ms"],
            "bound_ms": per * t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": per * t["library_ms"], "blocks_per_launch": t["blocks"],
        })
        bound_fp32[kname] = per * t["bound_fp32_ms"]
    for kname, src, replaces in (
        ("flash_fwd", "src/repro_torch/kernels/csrc/flash_fwd.cu",
         "src/repro/kernels/flash.py:80"),
        ("flash_bwd_dq", "src/repro_torch/kernels/csrc/flash_bwd.cu",
         "src/repro/kernels/flash.py:162"),
        ("flash_bwd_dkv", "src/repro_torch/kernels/csrc/flash_bwd.cu",
         "src/repro/kernels/flash.py:196"),
    ):
        launches = spmd_bf16["launches"][kname + "_bf16"]
        per = launches / BF16_STEPS
        t = bf16_t[kname]
        rows.append({
            "name": kname + "_bf16", "route": "cuda", "source": bf16_source(src),
            "replaces": replaces,
            "launches": launches, "max_abs_err": bf16_errs[kname],
            "ms": per * t["ms"], "plain_ms": per * t["plain_ms"],
            "bound_ms": per * t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": per * t["library_ms"], "blocks_per_launch": t["blocks"],
        })
    # B1-B3 at head dim 128: per step of qwen3_0_6b's 1F1B path, float32 and
    # bf16 (launches of the catalog_1f1b runs)
    for precision, sfx, t_of, e_of in (("f32", "", h128_t, h128_errs),
                                       ("bf16", "_bf16", h128b_t, h128b_errs)):
        for kname, src, replaces in (
            ("flash_fwd", "src/repro_torch/kernels/csrc/flash_fwd.cu",
             "src/repro/kernels/flash.py:80"),
            ("flash_bwd_dq", "src/repro_torch/kernels/csrc/flash_bwd.cu",
             "src/repro/kernels/flash.py:162"),
            ("flash_bwd_dkv", "src/repro_torch/kernels/csrc/flash_bwd.cu",
             "src/repro/kernels/flash.py:196"),
        ):
            launches = catalog[precision]["launches"][kname + sfx]
            per = launches / CATALOG_STEPS
            t = t_of[kname]
            rows.append({
                "name": kname + sfx + "_dh128", "route": "cuda",
                "source": bf16_source(src) if sfx else src, "replaces": replaces,
                "launches": launches, "max_abs_err": e_of[kname],
                "ms": per * t["ms"], "plain_ms": per * t["plain_ms"],
                "bound_ms": per * t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": per * t["library_ms"], "blocks_per_launch": t["blocks"],
            })
            if precision == "f32":
                bound_fp32[kname + "_dh128"] = per * t["bound_fp32_ms"]
    (OUT_DIR / "chip_smoke_summary.json").write_text(json.dumps(
        {"nvidia_smi": smi, "kernels": rows, "note": "ms, plain_ms, bound_ms and library_ms "
         "are per training step: B4 and B5 of the sim path, B1-B3 of the SPMD 1F1B path; "
         "launches are the counts of those runs. B4's and B5's spmd_* keys are per SPMD step. "
         "B5's ms is its grouped launch over the step's leaves, each with buffers of its own "
         "(cold in L2), per_leaf_ms the same leaves launched one by one. "
         "bound_ms of B4 and B1-B3 is the tensor route (3xTF32 at the TF32 rate, or bytes), "
         "bound_fp32_ms the float32 FMA route, per training step likewise. blocks_per_launch "
         "is the grid that B1-B3's launches recorded at the path shape. The library time of B2 and of B3 is the "
         "time of SDPA's whole backward (dQ, dK and dV in one call). The _bf16 rows are "
         "B1-B3's bfloat16 entry points per step of the SPMD 1F1B path under --precision "
         "bf16 (launches: its 4-step run); their bound_ms counts the bf16 x bf16 products "
         "at the bf16 rate (B1's P V as two bf16 passes, P split into hi and lo parts; B2 "
         "and B3 multiply bf16 P and dS), and bf16 "
         "heads with float32 L and D; library_ms is SDPA in bf16. The _dh128 rows are "
         "B1-B3 at head dim 128 per step of qwen3_0_6b's SPMD 1F1B path (catalog_1f1b: "
         "4 stages, 8 microbatches; launches: its 3-step runs in float32 and bf16), timed "
         "at its path shape (16, 256, 128). The xlstm_* keys of B4 and B5 are per step of "
         "the sim path of xlstm_1_3b cut to 8 layers (xlstm_sim: its launches, its four B4 "
         "groups and one B5 group over its 39 rotated leaves); B4's xlstm_library_ms is "
         "torch.matmul on contiguous operands of each of the step's products. The "
         "paper_1b_* keys of B4 and B5 are per step of paper_1b's sim path (paper_1b_sim: "
         "its launches, its four B4 groups and one B5 group over its 144 rotated leaves). "
         "Every training path calls B5's in-place entry (v' written over v); adam_scale's "
         "max_abs_err covers both entries, and the in-place entry's time is "
         "adam_grouped's inplace_ms on phase 2's line",
         "bound_fp32_ms": bound_fp32,
         "spmd_fill_drain_launches": spmd["fill_drain"]["launches"],
         "spmd_bf16_launches": spmd_bf16["launches"],
         "resume_sim_launches": [resume_sim[leg]["launches"]
                                 for leg in ("first_leg", "resumed_leg")],
         "resume_spmd_launches": [resume_spmd[leg]["launches"]
                                  for leg in ("first_leg", "resumed_leg")],
         "sim_modes_launches": {m: r["launches"] for m, r in modes.items()},
         "xlstm_sim_launches": xsim["launches"],
         "paper_1b_sim_launches": p1b["launches"],
         "baselines_launches": {path: {n: r["launches"] for n, r in runs.items()}
                                for path, runs in baselines.items()}}, indent=1))
    emit({"bound_fp32_ms": bound_fp32})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
