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
   timed at the path shape beside SDPA. At head dims 64 and 128 both entry
   points also run the edges of 64-row tiles (S = 65, 129, and keys past a
   ragged seq_len). At both path shapes B1's O and B2's and B3's outputs,
   in both dtypes, are held against float64 within F64_ERR_FACTOR of their
   plain versions' error. The float32 B1 (3xTF32 on wgmma,
   flash_fwd_f32.cu) prints its time beside SDPA's float32 forward, ptxas's
   registers and spills and its error against float64, beside the old
   kernel's time (``flash_f32_fwd``); the float32 B2 and B3 (3xTF32 on
   wgmma at head dim 128, flash_bwd_f32.cu) the same beside SDPA's float32
   backward (``flash_f32_bwd``). The bf16 B1 (wgmma,
   flash_fwd_bf16.cu) and B2 and B3 (flash_bwd_bf16.cu) print, at both path
   shapes, their time beside SDPA's bf16 forward or backward, ptxas's
   registers and spills, their error against float64 and their tensor
   maps' host ns, each beside the old kernels' (``flash_bf16_fwd``,
   ``flash_bf16_bwd``). At head widths 48 and 96, which no kernel is built
   for, both entry points run zero-padded to 64 and 128 at the true width's
   scale, as ``flash_attention`` runs them, and are held to their plain
   versions at the true width (``flash_widths``).
   ``tune`` then runs ``python -m repro_torch.tune --measure`` into a
   temporary cache at its default shapes and at paper_1b's grouped B5
   launch: every chunk B5 takes, timed cold, beside the card's name and
   power limit; B1-B3 and B4 timed at their one geometry. In-process, B5
   at paper_95m's leaves with each chunk must equal the default chunk's bit
   for bit, and with the cache named the next launch must take the cached
   chunk. ``analysis`` runs the static analyzer's matrix on the card
   (``python -m repro_torch.analysis --no-hlo`` over the Adam and basis
   rotation columns: every check passes, B1-B5 each launch, their launches
   billed to tick scopes per tick); ``examples`` trains
   ``examples/quickstart_torch.py`` 20 steps a optimizer on the card (B4
   and B5 counted), its first 3 losses within the smoke tolerances of the
   CPU's. The dry runs (the long-sequence phases read them) start on the
   host right after the build.
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
   schedule and the fill-drain schedule for 4 steps each. Checks finite losses and the exact launch counts of all
   five kernels. ``spmd_bf16`` trains the 1F1B path under ``--precision
   bf16`` for 2 steps: B1-B3 through their bf16 entry points only (2 M L and
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
   ``data_async`` drives the asynchronous data axis on one list of three
   16-row batches sampled once: the sim path for 3 steps on their first 8
   rows without the flags and with ``--data-async --data-delay`` 0, 1 and
   2 (finite losses, B4 4 and B5 1 launches a step, D = 0 bit for bit the
   losses without the flags, the delay rings' bytes by leaf kind as
   allocated equal to ``expected_rings_by_kind``'s (tau + D) x numel x 4
   from the shapes alone), and the 1F1B path with ``--batch 16 --data-par
   2 --data-async --data-delay 2`` for 3 steps (two data replicas in one
   process, one row of every microbatch each: per step B1 2 R M L = 1,024,
   B2 and B3 R M L = 512, B4 4, B5 1; its stage rings equal to the
   formula's, K-1 slots a stacked leaf whatever D), its peak beside the
   state, the FIFO's D float32 copies of the parameters and the running
   sum of the replicas' local gradients, one more (``reckon_sim(replicas=)``),
   and split at the local gradients (``peak_probe``: the peak inside them
   and outside them).
   ``spawn_spmd`` runs the multi-process SPMD path: phase 4's 1F1B run
   over two ranks of ``repro_torch.launch.spawn`` sharing the card over
   gloo (host-staged transfers; rank 0 stages 0-3, rank 1 stages 4-7).
   (a) and (b) are one launch: 3 steps checkpointing every step, rank 1
   killed once step 1 commits and the run resumed on two ranks; the merged
   series within 1e-6 of phase 4's first 3 losses. Per rank of the resumed
   launch (steps 1-2, uninterrupted): its launches a step, B1-B3 summing
   to 512 / 256 / 256, B4 and B5 a whole step's each; step and data times
   (each rank samples its batches), peak memory beside its slab's reckoning
   (``reckon_sim(stage_slab=)``), bytes sent a step, barrier waits. (c)
   ``--pods 2 --data-par 1`` at batch 16 over the two ranks (every stage of
   one data replica each) within 1e-6 of the one-process ``--pods 2`` run
   of the same batches (``data_async``'s, sampled once; run in this process
   while (c) runs), killed after the step-1 checkpoint and resumed as one
   process on (stages=8), 2 steps in all: finite and within 1e-4 of the
   one-process run's losses. (c) runs first and (a)/(b) starts when (c)'s
   first launch ends. With two or more cards (a) runs again over NCCL, one
   rank a card; with one card a line says why it was not run. Phase 3
   samples its batches and keeps them (``stream_tape``); phase 4's runs,
   the resume paths and ``sim_modes`` replay them, and their lines say so
   (``"data": "replayed"``): their data times are copies.
   ``baselines`` trains the paper's baseline optimizers on one list of two
   batches sampled once: each of the seven on the sim path for 2 steps, and
   delay compensation, pipedream_lr and muon on the SPMD 1F1B path for 2.
   Each run's first loss must equal phase 3's (sim) or phase 4's 1F1B one
   within 1e-6; B4 and B5 (basis rotation's) launch 0 times, B1-B3 as the
   1F1B path launches them. It reports each run's losses, step times, peak
   memory and, for delay compensation, its weight queues' bytes.
   ``catalog_1f1b`` trains the full-width qwen3_0_6b (28 layers, head dim
   128, GQA 16/8, qk_norm, vocab 151,936) through the launcher on the SPMD
   1F1B path (4 stages, 8 microbatches, basis rotation, ``--use-kernels``)
   for 2 steps in ``--precision f32`` and 2 in ``bf16``, from one list of
   two batches sampled once: finite losses and per step B1 448, B2 and B3
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
   ``profile_step`` breaks down one of its steps. ``serve_decode_xlstm``
   serves the same cut like qwen3_0_6b, its float32 prompt logits within the
   reference's xLSTM consistency tolerance (1e-3) of ``forward_train``'s.
   ``paper_1b_sim`` trains the paper's 1B model (24 layers, d_model 1728,
   27 heads of dh 64, d_ff 6912, vocab 50,304) at full width through the
   launcher on the sim path (8 stages, basis rotation, ``--use-kernels``)
   for 6 steps, after printing what the step must hold by kind, reckoned
   on the meta device (``reckon_sim``; layers are cut only if that does not
   fit): finite losses, per step four B4 launches and one B5 launch (in
   place) over its 144 rotated leaves, B1-B3 none, and the peak beside the
   reckoning. ``llava_sim``, ``musicgen_sim`` and ``mixtral_sim`` train the
   catalog's frontend and MoE configs at full width through the launcher
   on the sim path for 4 steps, each cut by ``fit_sim`` (layers, then
   llava's batch; never widths or the prefix) to what its reckoning
   (``reckon_sim`` with the optimizer and the dense attention over text
   and prefix) says fits 90% of the card, and each printing that
   reckoning first (``*_reckoning``): llava_next_34b (d_model 7168, 56
   heads over 8 KV heads, d_ff 20480, vocab 64,000, the 2,880-token vision
   prefix of width 1152 before 256 text tokens) on one stage with
   ``--data-async --data-delay 1``, basis rotation; musicgen_large (d_model
   2048, four codebooks of 2,048) on 8 stages, basis rotation, batch 8;
   mixtral_8x22b (d_model 6144, 8 experts top-2 of d_ff 16384, window 4096)
   on one stage, one step stale, with Adam (its basis-rotation reckoning is
   printed beside: it does not fit); llava and mixtral at lr 1e-4. Finite
   losses, per step B4 4 and B5 1 launches
   (mixtral: none), step, data and refresh times, the peak
   beside the reckoning. ``jamba_sim`` trains jamba_v0_1_52b (d_model
   4096, the Mamba mixer's d_inner 8192 and d_state 16, d_ff 14336, vocab
   65,536) the same way, cut by ``fit_sim`` to one layer (its Mamba mixer
   and a dense SwiGLU MLP), on one stage one step stale, basis rotation,
   lr 1e-4, batch 8: its reckoning (``jamba_reckoning``, the scan's
   activations counted) first, then B4 4 and B5 1 launches a step, finite
   losses and the peak beside the reckoning; ``jamba_profile`` splits one
   of its steps (``profile_step``: the Mamba scan's profiler ranges give
   its share of device time and of host time); ``serve_decode_jamba``
   serves the same cut, its float32 prompt logits within the reference's
   Mamba tolerance (1e-3) of ``forward_train``'s, then in bf16.
   ``deepseek_forward_backward`` draws one of deepseek_v2_236b's 60 layers
   (d_model 5120, MLA with 128 heads, 160 routed experts top-6 and 2
   shared, vocab 102,400: 5.02 G parameters) on the card and runs the
   training step's forward and backward on one batch of 8 x 256: the loss
   finite and within 1.0 of ln(vocab), every gradient finite, the peak
   beside a reckoning (no optimizer step: under Adam the layer alone would
   hold 80.3 GB); ``serve_decode_deepseek`` decodes from the same weights at
   a capacity factor where no expert drops a token, its float32 prompt
   logits within 2e-4 of ``forward_train``'s, then in bf16. Phase 2 holds
   and times B4 and B5 at llava's, musicgen's and jamba's groups (B4's
   contraction up to K = 20480), and the kernel line has a row for each.
   Then the long-sequence paths. ``long_context_check`` holds them on the
   card at a small size (query blocks and threshold lowered to 16 at S =
   64) against the paths they replace: chunked GQA and MLA within 2e-4 of
   dense, the chunked cross-entropy within 1e-5 of the whole one, and the
   stacked model under both remat policies within 2e-5 of the per-layer
   model (outputs and every gradient). Then qwen3_0_6b at full width, 14
   of its 28 layers (``LONG_LAYERS``, the script's time limit; 28 until PR
   32), float32, stacked (``scan_layers=True``) under full remat with
   ``loss_chunk`` 2,048, at 32,768 tokens, through the dry run's step
   functions (``repro_torch.launch.dryrun``): ``long_context_train``, one
   basis-rotation step of ``make_train_step`` at batch 1 (B4 4 and B5 1
   launches over the seven 14-layer leaves, B5 in place, B1-B3 none:
   query-chunked attention is the no-kernel path), more layers cut only if
   the dry run's reckoning of the step passed 90% of the card;
   ``long_context_prefill``, ``make_prefill_step`` at the largest batch the
   dry run reckons under 90% of the card, at most 3 (``LONG_PREFILL_BATCH``,
   the script's time limit); ``long_context_decode``, one
   ``make_serve_step`` at position 32,767 of a stacked cache, batch cut the
   same way; each with its time, its peak beside the dry run's reckoned
   peak for the same config and (batch, seq), and its launches. Since the
   build, three subprocesses that see no card have run ``launch.dryrun
   --all`` and ``launch.dryrun_pipeline`` under each schedule on the meta
   device;
   ``dryrun`` waits for them and counts their rows' statuses (every
   process exits 0, a row for each of the 40 (arch, shape) pairs, no
   error, every ok row with its ``sharded`` bytes of one device of the
   reference's grid). Phase 2 holds and times B4 and B5 at that train step's groups
   (kernel-line rows ``matmul_long_context``, ``adam_scale_long_context``).
   ``peaks`` prints the peaks of phases 3-4, ``catalog_1f1b``
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
   on the sim path) with Adam and basis rotation, the SPMD 1F1B path in
   bf16 (first loss within 1e-2, all within 5e-2), and the asynchronous
   data axis: sim ``--data-async --data-delay 2`` with Adam, and 1F1B
   ``--data-par 2 --data-async --data-delay 1`` with Adam and with basis
   rotation; and llava_next_34b, musicgen_large, mixtral_8x22b and
   jamba_v0_1_52b on the sim path, mixtral on 1F1B with a window of 16 and
   deepseek_v2_236b on the sim and 1F1B paths, each with Adam and with basis
   rotation through the kernels; and musicgen_large's codebook decode, its
   prompt logits card against CPU within 1e-4.

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
import io
import json
import math
import os
import re
import shutil
import signal
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
# card against CPU at smoke size: 3 steps, enough for the first-two and
# every-loss gates
SMOKE_ARGS = ["--smoke", "--stages", "2", "--steps", "3", "--batch", "4",
              "--seq", "32", "--log-every", "0"]
SPMD_ARGS = ["--arch", "paper_95m", "--backend", "spmd", "--stages", "8",
             "--microbatches", "8", "--optimizer", "basis_rotation", "--use-kernels",
             "--batch", "8", "--seq", "256", "--log-every", "1"]
# 4 steps each, the first a refresh: enough for launch counts and step
# times, and short enough to leave the script's time to the later paths
SPMD_STEPS = {"1f1b": 4, "fill_drain": 4}
BF16_STEPS = 2  # steps of the 1F1B path under --precision bf16
RESUME_CUT = {"sim": 6, "spmd": 2}  # the step each resume check checkpoints at
MODE_STEPS = 2  # steps of each sim staleness mode
# the asynchronous data axis: the sim path with each data delay (and without
# the flags), and the 1F1B path with two data replicas in one process, each
# DATA_ASYNC_STEPS steps on one list of 16-row batches sampled once (the sim
# runs take the first 8 rows of each)
DATA_ASYNC_STEPS = 3
DATA_ASYNC_SIM_DELAYS = (0, 1, 2)
DATA_ASYNC_SPMD = {"replicas": 2, "delay": 2, "batch": 16}
# the paper's baselines: each on the sim path, and three on the SPMD 1F1B path
# (the stage weight queues, per-stage factors, Newton-Schulz over stacked leaves)
BASELINES_SIM = ("adasgd", "nesterov", "nesterov_pp", "pipedream_lr", "delay_compensation",
                 "muon", "scion")
BASELINES_SPMD = ("delay_compensation", "pipedream_lr", "muon")
BASELINE_STEPS = {"sim": 2, "spmd": 2}
FIRST_LOSS_TOL = 1e-6  # a first loss against phase 3's or 4's: same weights and batch, no update
# card against CPU at smoke size: the elementwise baselines differ by float32
# summation order, as Adam does; Newton-Schulz's quintic steps amplify that in
# the smallest singular directions (muon, scion), and scion's sign flips where
# its momentum is within roundoff of zero
NEWTON_SCHULZ = ("muon", "scion")
RESUME_TOL = 1e-6  # resumed losses against the uninterrupted run's, same card and code
# the multi-process SPMD path (``spawn_spmd``): two ranks of repro_torch.launch.spawn
# sharing the card over gloo, on phase 4's 1F1B path (rank 0 stages 0-3, rank 1
# stages 4-7). SPAWN_STEPS of phase 4's steps: the schedule's learning rate at
# steps 0 and 1 does not depend on --steps, so 3 steps give phase 4's first 3
# losses; rank 1 is killed after SPAWN_CUT steps and the run resumed on two
# ranks. (c) runs the data axis over the two ranks at batch 16 (one row of
# each microbatch a rank) for SPAWN_PODS_STEPS steps against the one-process
# --pods 2 run, cut after SPAWN_PODS_CUT steps and resumed as one process on
# (stages=8)
SPAWN_STEPS, SPAWN_CUT = 3, 1
SPAWN_PODS_STEPS, SPAWN_PODS_CUT = 2, 1
SPAWN_TOL = 1e-6  # multi-process losses against the one-process run's, same card
# (c)'s resumed (stages=8) losses against the one-process --pods 2 run's: the
# same mean gradient (two replicas of one row, or one of two rows) summed in
# another order
SPAWN_CONTINUITY_TOL = 1e-4
SPAWN_TIMEOUT = 300  # seconds each spawn may take
# qwen3_0_6b at full width on the SPMD 1F1B path: 4 stages of 7 layers (its
# 28 layers fix the stage counts that divide them), 8 microbatches of one
# sequence; CATALOG_STEPS steps in float32 and then in bf16 on one list of
# batches sampled once (host sampling at vocab 151,936 costs seconds a batch)
CATALOG_ARGS = ["--arch", "qwen3_0_6b", "--backend", "spmd", "--schedule", "1f1b",
                "--stages", "4", "--microbatches", "8", "--optimizer", "basis_rotation",
                "--use-kernels", "--batch", "8", "--seq", "256", "--log-every", "1"]
CATALOG_STEPS = 2  # the first a refresh
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
# 6 steps (cut from 12 for the script's time limit): the refresh at step 0 and
# five steps after it. The layers are cut only if the reckoning (``reckon_sim``)
# does not fit the card
PAPER_1B_ARGS = ["--arch", "paper_1b", "--backend", "sim", "--stages", "8",
                 "--optimizer", "basis_rotation", "--use-kernels", "--steps", "6",
                 "--batch", "8", "--seq", "256", "--log-every", "1"]
# the catalog's frontend and MoE configs at full width on the sim path, each
# through the launcher for 4 steps, cut in depth (and llava in batch) to what
# ``fit_sim`` reckons fits FIT_SHARE of the card. llava_next_34b: one stage,
# every leaf one step stale through the data axis, basis rotation, 256 text
# tokens after its 2,880-token vision prefix (never cut), the batch the
# largest of LLAVA_BATCHES whose dense attention fits. musicgen_large: 8
# stages, basis rotation, its layers cut to a multiple of 8. mixtral_8x22b:
# Adam (its bases and grams would not fit beside one layer), one stage, one
# step stale; basis rotation is held card against CPU at smoke size.
# llava and mixtral train at lr 1e-4: at the launcher's 1e-3 with one
# warm-up step the first applied update sent their single wide layers'
# losses from 11.39 to 16.15 and from 10.79 to 20.00 (PERF.md §6)
LLAVA_ARGS = ["--arch", "llava_next_34b", "--backend", "sim", "--stages", "1", "--data-async",
              "--data-delay", "1", "--optimizer", "basis_rotation", "--use-kernels",
              "--steps", "4", "--seq", "256", "--lr", "1e-4", "--log-every", "1"]
LLAVA_BATCHES = (8, 4, 2, 1)
MUSICGEN_ARGS = ["--arch", "musicgen_large", "--backend", "sim", "--stages", "8",
                 "--optimizer", "basis_rotation", "--use-kernels", "--steps", "4",
                 "--seq", "256", "--log-every", "1"]
MIXTRAL_ARGS = ["--arch", "mixtral_8x22b", "--backend", "sim", "--stages", "1", "--data-async",
                "--data-delay", "1", "--optimizer", "adam", "--steps", "4", "--seq", "256",
                "--lr", "1e-4", "--log-every", "1"]
# jamba_v0_1_52b at full width on the sim path, run as llava's is: one stage,
# every leaf one step stale through the data axis, basis rotation, lr 1e-4,
# batch 8, cut in depth by fit_sim: one layer, its Mamba mixer with a dense
# SwiGLU MLP (the second layer's rotated (16, 4096, 14336) expert stacks alone
# would add ~85 GB of bases and grams). Then its decode, held to the
# reference's Mamba tolerance (tests/test_models.py:74-81)
JAMBA_ARGS = ["--arch", "jamba_v0_1_52b", "--backend", "sim", "--stages", "1", "--data-async",
              "--data-delay", "1", "--optimizer", "basis_rotation", "--use-kernels",
              "--steps", "4", "--seq", "256", "--lr", "1e-4", "--log-every", "1"]
JAMBA_DECODE_TOL = 1e-3
# deepseek_v2_236b at full width: one of its 60 layers, 5.02 G parameters
# (20.1 GB float32), drawn once on the card. Its optimizer state does not fit
# beside it (under Adam the layer holds 80.3 GB of masters, gradients, m and
# v), so the phase runs the training step's forward and backward on one batch
# of (batch, seq) and then decodes from the same weights
DEEPSEEK_LAYERS = 1
DEEPSEEK_BATCH = (8, 256)
DEEPSEEK_LOSS_TOL = 1.0  # random weights: the first loss within this of ln(vocab)
FIT_SHARE = 0.9  # of the card's memory a path's reckoned peak may take
# the long-context phase: qwen3_0_6b stacked under full remat, float32, the
# chunked cross-entropy, at prefill_32k's length (above the 8,192-token
# threshold of the query-chunked attention)
LONG_ARCH = "qwen3_0_6b"
LONG_SEQ = 32_768
# one step, the refresh step: the phase's time is set by (b)'s batch and by
# this step's ~57 s (PERF.md §6), and the script must keep its time limit
LONG_STEPS = 1
# layers of the 28, cut for the script's time limit (the train step and the
# prefill scale with depth: 67 s and 41 s at 28 layers, PERF.md §6, PR 32)
LONG_LAYERS = 14
# prefill rows, cut from the largest batch the reckoning fits under FIT_SHARE (7
# at 28 layers) for the script's time limit
LONG_PREFILL_BATCH = 3
LONG_OVERRIDES = {"dtype": "float32", "remat_policy": "full", "loss_chunk": 2048}
LONG_CHECK_TOL = 2e-4  # chunked attention against dense (tests/test_models.py:127)
LONG_CE_TOL = 1e-5  # chunked cross-entropy against whole (tests/test_models.py:227, :232)
LONG_STACK_TOL = 2e-5  # stacked against per-layer (tests/test_models.py:211)
DRYRUN_TIMEOUT = 900  # seconds the meta-device dry runs may take, from their start
# peak device memory (GB) of the earlier paths before the optimizer state was
# updated in place (chip_smoke.py on one H100 80GB HBM3 at 700 W, PERF.md §5):
# the state is now updated in its own tensors, so none may grow past these
EARLIER_PEAKS_GB = {"main_path": 7.898, "spmd_1f1b": 9.11, "catalog_1f1b": 57.23,
                    "xlstm_sim": 60.08}

# the card's published peaks (float32 outside the tensor cores, device memory
# bandwidth, TF32 and bf16 on the tensor cores) come from the port's one
# table of H100 figures, ``repro_torch.launch.roofline.CARD_PEAKS``
TF32_PASSES = 3  # the 3xTF32 split: three tensor-core products per float32 product
# a B4 group timed over 2 launches, not 10 (xlstm_1_3b's, paper_1b's; their
# spread is well below a percent, and the script must keep its time limit)
LONG_GROUP_FLOPS = 2e12

SLEEP_CYCLES = 50_000_000  # ~25 ms at 2 GHz: longer than the host takes to enqueue a timing run
# ~0.1 s at 2 GHz: five times what the host took to enqueue the longest of one
# step's B5 work leaf by leaf (19.4 ms for the paper_95m sim path's 192 leaves on
# the host of one NVIDIA H100 80GB HBM3 machine);
# ``time_step_ms`` checks every run against it
STEP_SLEEP_CYCLES = 200_000_000
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
# the float32 B1 before its redesign for wgmma (16-row blocks on mma.sync; 4
# warps a block at head dim 128), at each path shape: us per launch (PERF.md
# section 6), one NVIDIA H100 80GB HBM3 at 700 W; phase 2 prints the new
# kernel's own beside them
OLD_F32_FWD = {(6, 256, 64): {"us": 12.99}, (16, 256, 128): {"us": 38.34}}
# the float32 B2 and B3 before their redesign for wgmma (16-row blocks on
# mma.sync; 4 warps a block at head dim 128, B3 there two blocks a key tile,
# each owning half of dh's columns), at each path shape: us per launch (PERF.md
# section 6), one NVIDIA H100 80GB HBM3 at 700 W; phase 2 prints the new
# kernels' own beside them (at head dim 64 the mma.sync kernels still serve)
OLD_F32_BWD = {
    (6, 256, 64): {"flash_bwd_dq": {"us": 14.56}, "flash_bwd_dkv": {"us": 17.25}},
    (16, 256, 128): {"flash_bwd_dq": {"us": 36.06}, "flash_bwd_dkv": {"us": 71.89}},
}
# B1, B2 and B3 x float32 and bf16 entry points (each its own kernel) x head dims
# 16, 32, 64, 128
FLASH_INSTANTIATIONS = 24
# head widths the flash kernels are not built for, run zero-padded to the next
# built width (``kernels.flash.padded_width``), at (heads, S 256)
FLASH_WIDTHS = (48, 96)
FLASH_WIDTH_HEADS = 6
TUNE_TIMEOUT = 120  # seconds each ``python -m repro_torch.tune`` run may take
# the static analyzer on the card (``python -m repro_torch.analysis --no-hlo``):
# the Adam column, and basis rotation's for B4 and B5
ANALYSIS_OPTIMIZERS = ("adam", "basis_rotation")
# examples/quickstart_torch.py: steps on the card, of which the first are
# held against the CPU (the smoke tolerances: Adam 1e-4, rotation 2e-3 on
# the first two steps, 5e-2 on all)
EXAMPLE_STEPS, EXAMPLE_CPU_STEPS = 20, 3
EXAMPLE_TOL = {"adam": (1e-4, 1e-4), "basis_rotation": (2e-3, 5e-2)}


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it ended, in seconds
    since the script started, and is kept in chiprun_out/chip_smoke_phases.jsonl
    (the end of the standard output alone reaches back only so far)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
        with open(OUT_DIR / "chip_smoke_phases.jsonl", "a") as f:
            f.write(json.dumps(obj) + "\n")
    print(json.dumps(obj), flush=True)


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


def time_step_ms(fn, reps: int = 5, warmup: int = 2):
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
    return re.sub(r"flash_bwd(_f32)?\.cu", "flash_bwd_bf16.cu", src).replace(
        "flash_fwd_f32.cu", "flash_fwd_bf16.cu")


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
            # launch, whose spread is well below a percent: one timed run
            # after one warmup (cut from two for the script's time limit)
            reps, warmup = (1, 1) if flops > LONG_GROUP_FLOPS else (10, 2)
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
    case of ragged length. At head dims 64 and 128 (the float32 B1 on
    wgmma) the edges of its 64-row tiles: a row past one tile, a row past
    two under a window of 8, and keys past a ragged seq_len of 100 (rows >=
    107 see none)."""
    edges = [((2, 65, path[2]), None, None), ((2, 129, path[2]), 8, None),
             ((2, 129, path[2]), 8, 100)]
    if path[2] == 128:
        return [(path, None, None), ((4, 200, 128), 100, None)] + edges
    cases = [(path, None, None)]
    cases += [((6, S, 64), w, None) for S in (256, 128) for w in (None, 100, 32)]
    cases += [((2, S, 32), w, None) for S in (200, 100) for w in (None, 100, 32, 16)]
    cases += [((1, 128, 16), 8, 100)]  # keys past 100 masked: rows >= 107 see none
    return cases + edges


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
    # B1 against a float64 forward from the same inputs (the error of O), B2
    # and B3 against a float64 backward from the same inputs, L and D:
    # relative Frobenius error (of dK or dV, the larger), each held to a
    # multiple of the plain version's
    x64 = [x.double() for x in (q, k, v, do, L, D)]
    want = {"flash_fwd": (kflash.flash_fwd_plain(*x64[:3])[0],),
            "flash_bwd_dq": (kflash.flash_bwd_dq_plain(*x64),),
            "flash_bwd_dkv": kflash.flash_bwd_dkv_plain(*x64)}
    for name, w in want.items():
        def rel(fn):
            got = fn(q, k, v)[:1] if name == "flash_fwd" else fn(q, k, v, do, L, D)
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


def check_flash_widths(torch, kflash):
    """B1-B3 at head widths they are not built for (``FLASH_WIDTHS``, S 256,
    float32 and bf16), as ``flash_attention`` runs them: q, k, v and dO
    zero-padded to ``padded_width``, the scale of the true width passed to
    each kernel, the outputs sliced back. Each is held against its plain
    version at the true width on the same inputs (B2 and B3 on the kernel's
    L and D), within the path cases' tolerances; the padded columns of O
    must be zero, and ``flash_attention``'s forward must equal the padded
    launch bit for bit. Returns (rows, errs)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows, errs = [], {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    pad = torch.nn.functional.pad
    for dh in FLASH_WIDTHS:
        width, scale = kflash.padded_width(dh), kflash._scale(dh)
        for dtype in (torch.float32, torch.bfloat16):
            BH, S = FLASH_WIDTH_HEADS, 256
            q, k, v, do = (torch.randn((BH, S, dh), device="cuda", generator=gen).to(dtype)
                           for _ in range(4))
            qp, kp, vp, dop = (pad(x, (0, width - dh)) for x in (q, k, v, do))
            o_pad, L = kflash.flash_fwd(qp, kp, vp, scale=scale)
            o = o_pad[..., :dh]
            D = (do.float() * o.float()).sum(-1)
            dq = kflash.flash_bwd_dq(qp, kp, vp, dop, L, D, scale=scale)[..., :dh]
            dk, dv = (x[..., :dh] for x in kflash.flash_bwd_dkv(qp, kp, vp, dop, L, D,
                                                                scale=scale))
            o_p, L_p = kflash.flash_fwd_plain(q, k, v)
            dq_p = kflash.flash_bwd_dq_plain(q, k, v, do, L, D)
            dk_p, dv_p = kflash.flash_bwd_dkv_plain(q, k, v, do, L, D)
            whole = kflash.flash_attention(*(x.reshape(1, BH, S, dh) for x in (q, k, v)))
            torch.cuda.synchronize()
            if not (torch.equal(o_pad[..., dh:], torch.zeros_like(o_pad[..., dh:]))
                    and torch.equal(whole.reshape(BH, S, dh), o)):
                raise AssertionError(f"flash at dh {dh} {dtype}: padded columns of O not zero "
                                     "or flash_attention differs from the padded launch")
            f32 = dtype == torch.float32
            fwd_tol = ((FWD_RTOL, FWD_ATOL), (FWD_RTOL, FWD_ATOL)) if f32 else (
                (BF16_TOL, BF16_TOL), (BF16_L_TOL, BF16_L_TOL))
            bwd_tol = (BWD_RTOL, BWD_ATOL) if f32 else (BF16_TOL, BF16_TOL)
            row = {"dh": dh, "padded_to": width, "dtype": str(dtype).split(".")[-1],
                   "shape": [BH, S, dh]}
            for name, pairs in (("flash_fwd", ((o, o_p) + fwd_tol[0], (L, L_p) + fwd_tol[1])),
                                ("flash_bwd_dq", ((dq, dq_p) + bwd_tol,)),
                                ("flash_bwd_dkv", ((dk, dk_p) + bwd_tol, (dv, dv_p) + bwd_tol))):
                err = max((a.float() - b.float()).abs().max().item() for a, b, _, _ in pairs)
                row[name + "_max_abs_err"] = err
                errs[name] = max(errs[name], err)
                if not all(torch.allclose(a.float(), b.float(), rtol=rt, atol=at)
                           for a, b, rt, at in pairs):
                    raise AssertionError(f"{name} at dh {dh} padded to {width} ({dtype}): "
                                         f"max abs err {err}")
            rows.append(row)
    return rows, errs


def tune_phase(torch, kadam, smi):
    """``python -m repro_torch.tune --measure`` into a temporary cache: its
    default shapes (paper_95m's grouped B5 launch, B1-B3 at (256, 64) in
    float32 and bf16 and at (256, 128), B4 at paper_95m's rotation
    products), then, through the same CLI's ``main`` in this process,
    paper_1b's grouped B5 launch. The tuner times every
    chunk B5 takes cold and holds it bitwise to the rule's chunk. Here,
    in-process at paper_95m's leaves: the launch with each candidate chunk
    must equal the default chunk's bit for bit, and with the cache named the
    next launch must read the cached chunk. Returns the phase's line."""
    from repro_torch import tune
    from repro_torch.configs import get_config
    from repro_torch.launch.bench_matmul import path_groups
    from repro_torch.tune.__main__ import main as tune_main

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tune_")
    cache = os.path.join(tmp, "tune.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    try:
        out = subprocess.run([sys.executable, "-m", "repro_torch.tune", "--measure",
                              "--cache", cache], cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=TUNE_TIMEOUT)
        if out.returncode != 0:
            raise AssertionError(f"repro_torch.tune: exit {out.returncode}\n"
                                 f"{out.stderr[-4000:]}")
        # the same CLI's main in this process, which has the library loaded already
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            tune_main(["--measure", "--cache", cache, "--adam", "paper_1b"])
        plans = [json.loads(x) for x in (out.stdout + text.getvalue()).splitlines()
                 if x.startswith("{")]
        adam = {p["plan"]["of"]: p for p in plans if p["kernel"] == "adam_scale"}
        if set(adam) != {"paper_95m", "paper_1b"} or not all(
                p["plan"]["backend"] == "measured" and p["plan"]["bitwise_equal"]
                and set(p["plan"]["candidates_us"]) == {str(c) for c in kadam.CHUNKS}
                for p in adam.values()):
            raise AssertionError(f"tune: B5 plans {adam}")
        # in-process: every chunk bitwise equal to the default's, then the cache read
        _, shapes = path_groups(get_config("paper_95m"))
        gs, ms, vs = _adam_leaves(torch, torch.Generator(device="cuda").manual_seed(7), shapes)
        want = kadam.adam_scale_grouped(gs, ms, vs, *ADAM_SCALARS)
        default_chunk = kadam.adam_scale.chunks
        bitwise = {}
        for chunk in kadam.CHUNKS:
            got = kadam.adam_scale_grouped(gs, ms, vs, *ADAM_SCALARS, chunk=chunk)
            bitwise[chunk] = all(torch.equal(a, b) for x, y in zip(got, want)
                                 for a, b in zip(x, y))
            del got
        saved = os.environ.get("REPRO_TORCH_TUNE_CACHE")
        os.environ["REPRO_TORCH_TUNE_CACHE"] = cache
        tune.clear_memo()
        try:
            kadam.adam_scale_grouped(gs, ms, vs, *ADAM_SCALARS)
            read = kadam.adam_scale.chunks
        finally:
            if saved is None:
                os.environ.pop("REPRO_TORCH_TUNE_CACHE", None)
            else:
                os.environ["REPRO_TORCH_TUNE_CACHE"] = saved
            tune.clear_memo()
        del gs, ms, vs, want
        torch.cuda.empty_cache()
        if not all(bitwise.values()) or read != [adam["paper_95m"]["plan"]["chunk"]]:
            raise AssertionError(f"tune: bitwise by chunk {bitwise}; the launch after the "
                                 f"plan took chunks {read}, the plan "
                                 f"{adam['paper_95m']['plan']['chunk']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "tune", "nvidia_smi": smi, "s": time.perf_counter() - t0,
            "adam_scale": {arch: {
                "elements": p["shape"][0], "leaves": p["plan"]["leaves"],
                "rule_chunk": p["plan"]["rule_chunk"], "best_chunk": p["plan"]["chunk"],
                "candidates_ms": {c: us / 1e3 for c, us in p["plan"]["candidates_us"].items()}}
                for arch, p in adam.items()},
            "adam_bitwise_by_chunk": bitwise, "default_chunk": default_chunk,
            "chunk_read_from_cache": read,
            "flash_fwd_bwd_ms": {f"{p['shape'][0]}x{p['shape'][1]} {p['dtype']} "
                                 f"BH {p['plan']['batch_heads']}": p["plan"]["us"] / 1e3
                                 for p in plans if p["kernel"] == "flash"},
            "flash_cost_model_ms": {f"{p['shape'][0]}x{p['shape'][1]} {p['dtype']}":
                                    p["plan"]["cost_s"] * 1e3
                                    for p in plans if p["kernel"] == "flash"},
            "matmul_ms": {"x".join(map(str, p["shape"])): p["plan"]["us"] / 1e3
                          for p in plans if p["kernel"] == "matmul"},
            "matmul_cost_model_ms": {"x".join(map(str, p["shape"])): p["plan"]["cost_s"] * 1e3
                                     for p in plans if p["kernel"] == "matmul"}}


def analysis_phase(kernels, smi):
    """The static analyzer's matrix on the card, as ``python -m
    repro_torch.analysis --matrix smoke --no-hlo`` runs it over
    ``ANALYSIS_OPTIMIZERS``: every one-process check of the base cells (on
    the card the kernel path: B1-B3 in attention, B4 and B5 in basis
    rotation's update), the precision cells with and without kernels, the
    async-data cells, the scaling check (meta) and the lint. Fails on any
    failed check and on a kernel of B1-B5 that never launched; reports the
    launches billed to tick scopes, per tick, by cell."""
    from repro_torch.analysis import runner

    t0 = time.perf_counter()
    zero_counts(kernels)
    report = runner.run_matrix(optimizers=ANALYSIS_OPTIMIZERS, compile_hlo=False,
                               verbose=False, device="cuda")
    launches = read_counts(kernels)
    rows = report["cells"] + report["precision"] + report["data_async"]
    failed = [(r.get("schedule"), c["name"], c["detail"]) for r in rows + report["scaling"]
              for c in r["checks"] if not c["passed"]]
    if not report["passed"] or failed:
        raise AssertionError(f"analysis: failed checks {failed[:8]}, lint {report['lint']}")
    idle = [k for k, n in launches.items() if not n]
    if idle:
        raise AssertionError(f"analysis: kernels never launched on the card: {idle}")

    def tag(r):
        return "/".join(str(r[k]) for k in ("schedule", "sync", "precision", "optimizer",
                                            "topology") if k in r) + \
            ("/kernels" if r.get("use_kernels") else "")

    per_tick = {tag(r): {k: v for k, v in r["in_ticks_per_tick"].items() if v}
                for r in rows if r.get("launches")}
    outside = {tag(r): {k: v["outside"] for k, v in r["launches"].items() if v["outside"]}
               for r in rows if r.get("launches")}
    return {"phase": "analysis", "nvidia_smi": smi, "s": time.perf_counter() - t0,
            "matrix_s": report["seconds"], "cells": len(rows),
            "checks": sum(len(r["checks"]) for r in rows + report["scaling"]) + 1,
            "launches": launches, "in_ticks_per_tick": per_tick,
            "outside_ticks": outside,
            "ticks": {tag(r): r["ticks"] for r in rows if r.get("launches")}}


def examples_phase(torch, kernels, smi):
    """``examples/quickstart_torch.py`` on the card: both optimizers for
    ``EXAMPLE_STEPS`` steps from one draw of the weights, B4 and B5 in
    basis rotation's steps; the first ``EXAMPLE_CPU_STEPS`` held against
    the CPU's run of the same schedule within the smoke tolerances."""
    import importlib.util

    from repro_torch.kernels import adam_step as kadam
    from repro_torch.launch.bench_matmul import path_groups

    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    params = ex.initial_params(0, "cpu")
    groups, leaves = path_groups(ex.CFG)
    n = EXAMPLE_STEPS
    want = {k: 0 for k in kernels}
    want.update(matmul=n * sum(1 for g in groups if g),
                adam_scale=n * -(-len(leaves) // kadam.MAX_LEAVES))
    t0 = time.perf_counter()
    zero_counts(kernels)
    card = {name: ex.train(name, params, n, torch.device("cuda")) for name in ex.LABELS}
    launches = read_counts(kernels)
    card_s = time.perf_counter() - t0
    if launches != want:
        raise AssertionError(f"examples: kernel launches {launches}, expected {want}")
    out = {"phase": "examples", "nvidia_smi": smi, "example": "examples/quickstart_torch.py",
           "steps": n, "launches": launches, "card_s": card_s}
    for name, losses in card.items():
        cpu = ex.train(name, params, EXAMPLE_CPU_STEPS, "cpu", total_steps=n)
        diffs = [abs(a - b) for a, b in zip(losses, cpu)]
        first_tol, all_tol = EXAMPLE_TOL[name]
        if not all(math.isfinite(x) for x in losses) or max(diffs[:2]) >= first_tol \
                or max(diffs) >= all_tol:
            raise AssertionError(f"examples {name}: card {losses[:EXAMPLE_CPU_STEPS]} "
                                 f"against CPU {cpu}")
        out[name] = {"losses": losses, "cpu_losses": cpu, "max_abs_diff": max(diffs),
                     "final_10": sum(losses[-10:]) / len(losses[-10:])}
    out["s"] = time.perf_counter() - t0
    return out


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


def cpu_copy(model):
    """The model's weights in a model of its own on the CPU, copied straight
    from the card (no second copy on the card)."""
    from repro_torch.models import Transformer

    twin = Transformer(model.cfg, device="cpu", seed=None)
    twin.load_state_dict(model.state_dict())
    return twin


def check_serve_decode(torch, cfg, tol=DECODE_TOL, model=None):
    """Full-width decode on the card in float32 compute: the logits decoded
    at the prompt's positions against ``forward_train``'s on the prompt,
    within the reference's consistency tolerance ``tol``. Beside it, the
    same ``forward_train`` on the CPU against the card's: the size of
    float32 roundoff between two summation orders at this width and depth.
    Then the same serving run in the config's own compute dtype, on the
    same weights (``model``, or drawn once from the seed). Reports tokens
    per second of both."""
    from repro_torch.launch.serve_decode import serve
    from repro_torch.models import forward_train, init_model

    if model is None:
        model = init_model(cfg.replace(scan_layers=False), seed=0, device=torch.device("cuda"))
    out = {}
    for dtype in ("float32", cfg.dtype):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = serve(cfg.replace(dtype=dtype), SERVE["batch"], SERVE["prompt_len"],
                    SERVE["gen_len"], torch.device("cuda"), model=model)
        row = {"dtype": dtype, "wall_s": time.perf_counter() - t0,
               "tokens_per_s": res["tokens_per_s"], "decode_s": res["seconds"],
               "generated_shape": list(res["generated"].shape),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if dtype == "float32":
            with torch.no_grad():
                full, _ = forward_train(model, res["prompt"])
                on_cpu, _ = forward_train(cpu_copy(model), res["prompt"].cpu())
            got = res["prompt_logits"]
            row["forward_train_card_vs_cpu_max_abs_err"] = float(
                (full.cpu() - on_cpu).abs().max())
            err = row["prefill_vs_forward_train_max_abs_err"] = float((got - full).abs().max())
            row["logits_max_abs"] = float(full.abs().max())
            del on_cpu
            if not torch.allclose(got, full, rtol=tol, atol=tol):
                raise AssertionError(f"serve_decode: decoded prompt logits differ from "
                                     f"forward_train by {err}")
        if tuple(res["generated"].shape) != (SERVE["batch"], SERVE["gen_len"]) or not bool(
                ((res["generated"] >= 0) & (res["generated"] < cfg.vocab_size)).all()):
            raise AssertionError(f"serve_decode: generated {res['generated']}")
        out[dtype] = row
        del res
    return out


def check_deepseek(torch, get_config):
    """deepseek_v2_236b at full width, ``DEEPSEEK_LAYERS`` of its 60 layers,
    drawn once on the card from the seed. First the training step's forward
    and backward (``loss_fn``, ``.backward()``) in float32 on one batch of
    the synthetic stream: the loss finite and within ``DEEPSEEK_LOSS_TOL``
    of ln(vocab), every gradient finite, and the peak beside a reckoning of
    the masters, their gradients, the MLA scores (each layer's (B, H, S, S)
    float32 probabilities and three more such tensors while one layer's are
    formed or differentiated) and the logits (three float32 copies). No
    optimizer step: its state would not fit beside the layer. Then decode
    from the same weights (``check_serve_decode``), at a capacity factor of
    experts over top-k, where an expert takes every token of its group, so
    that training's groups and decode's drop none. Emits one line for each
    (``deepseek_forward_backward``, ``serve_decode_deepseek``)."""
    from repro_torch.data import batches
    from repro_torch.models import Transformer, loss_fn, param_count

    full = get_config("deepseek_v2_236b")
    cfg = full.replace(num_layers=DEEPSEEK_LAYERS, scan_layers=False, dtype="float32")
    B, S = DEEPSEEK_BATCH
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", seed=0, draw_device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = next(batches(cfg, B, S, seed=0, device="cuda"))
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss, metrics = loss_fn(model, batch)
    loss.backward()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    n = param_count(model)
    reckon = {"masters": 4 * n, "gradients": 4 * n,
              "scores": 4 * B * cfg.attention.num_heads * S * S * (DEEPSEEK_LAYERS + 3),
              "logits": 3 * 4 * B * S * cfg.vocab_size}
    peak = torch.cuda.max_memory_allocated()
    grads_finite = bool(torch.stack([torch.isfinite(p.grad).all()
                                     for p in model.parameters()]).all())
    ln_v = math.log(cfg.vocab_size)
    train = {"phase": "deepseek_forward_backward", "arch": cfg.name, "layers": DEEPSEEK_LAYERS,
             "layers_full": full.num_layers, "params": n, "batch": B, "seq": S,
             "loss": loss.item(), "ce": metrics["ce"].item(), "aux": metrics["aux"].item(),
             "ln_vocab": ln_v, "grads_finite": grads_finite, "draw_on_card_s": draw_s,
             "data_s": data_s, "forward_backward_s": step_s, "peak_mem_gb": peak / 1e9,
             "reckoned_gb": {k: v / 1e9 for k, v in reckon.items()},
             "reckoned_peak_gb": sum(reckon.values()) / 1e9,
             "peak_minus_reckoned_gb": (peak - sum(reckon.values())) / 1e9,
             "adam_state_gb": 16 * n / 1e9}
    emit(train)
    if not (math.isfinite(train["loss"]) and abs(train["loss"] - ln_v) < DEEPSEEK_LOSS_TOL
            and grads_finite):
        raise AssertionError(f"deepseek: loss {train['loss']} (ln V {ln_v}), "
                             f"gradients finite {grads_finite}")
    del loss, metrics, batch
    model.zero_grad(set_to_none=True)
    moe = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)
    serving = check_serve_decode(torch, cfg.replace(moe=moe, dtype=full.dtype), DECODE_TOL,
                                 model=model)
    emit({"phase": "serve_decode_deepseek", "arch": cfg.name, "layers": DEEPSEEK_LAYERS,
          "capacity_factor": moe.capacity_factor, **SERVE, **serving})
    del model
    torch.cuda.empty_cache()


def check_long_context_small(torch):
    """The long-sequence paths on the card at a small size, against the
    paths they replace, with the query block and threshold lowered to 16 at
    S = 64: query-chunked GQA and MLA (outputs and every gradient) within
    ``LONG_CHECK_TOL`` of the dense path, the chunked cross-entropy (loss
    and gradients) within ``LONG_CE_TOL`` of the whole-sequence one, and
    the stacked model under both remat policies within ``LONG_STACK_TOL``
    of the per-layer model holding the same weights (the tests' tolerances,
    from the reference's own: tests/test_models.py:127, :227, :211)."""
    from repro_torch.checkpoint.convert import stack_layers
    from repro_torch.configs import AttentionConfig, BlockSpec, ModelConfig
    from repro_torch.models import Transformer, loss_fn, param_leaves, use_config
    from repro_torch.models import attention as tattn

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(11)
    B, S, V = 2, 64, 97
    toks = torch.randint(0, V, (B, S), device="cuda", generator=gen)
    labels = toks.clone()
    labels[:, :5] = -100
    batch = {"tokens": toks, "labels": labels}

    def grads(model):
        params = param_leaves(model)
        loss, _ = loss_fn(model, batch)
        return loss.detach(), dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    def gap(a, b):
        return max((a[0] - b[0]).abs().item(),
                   max((a[1][k] - b[1][k]).abs().max().item() for k in a[1]))

    saved = (tattn.CHUNKED_ATTN_THRESHOLD, tattn.QUERY_BLOCK)
    for kind, att in (("gqa", AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16,
                                              qk_norm=True)),
                      ("mla", AttentionConfig(kind="mla", num_heads=4, num_kv_heads=4,
                                              kv_lora_rank=32, qk_nope_head_dim=16,
                                              qk_rope_head_dim=8, v_head_dim=16))):
        cfg = ModelConfig(num_layers=4, d_model=64, d_ff=128, vocab_size=V, max_seq_len=S,
                          attention=att, pattern=(BlockSpec("attn", "dense"),),
                          scan_layers=False)
        flat = Transformer(cfg, device="cuda", seed=3)
        dense = grads(flat)
        try:
            tattn.CHUNKED_ATTN_THRESHOLD, tattn.QUERY_BLOCK = 16, 16
            chunked = grads(flat)
        finally:
            tattn.CHUNKED_ATTN_THRESHOLD, tattn.QUERY_BLOCK = saved
        out[f"{kind}_chunked_attention_max_abs_err"] = gap(chunked, dense)
        use_config(flat, cfg.replace(loss_chunk=24))  # two chunks and a tail of 16
        out[f"{kind}_chunked_ce_max_abs_err"] = gap(grads(flat), dense)
        use_config(flat, cfg)
        want = {k: v.detach() for k, v in param_leaves(flat).items()}
        for policy in ("full", "dots"):
            scfg = cfg.replace(scan_layers=True, remat_policy=policy)
            stacked = Transformer(scfg, device="cuda", seed=None)
            with torch.no_grad():
                for k, v in stack_layers(want, scfg).items():
                    param_leaves(stacked)[k].copy_(v)
            got = grads(stacked)
            ref = (dense[0], stack_layers(dense[1], scfg))
            out[f"{kind}_stacked_{policy}_max_abs_err"] = gap(got, ref)
    tols = {"chunked_attention": LONG_CHECK_TOL, "chunked_ce": LONG_CE_TOL,
            "stacked_full": LONG_STACK_TOL, "stacked_dots": LONG_STACK_TOL}
    bad = {k: v for k, v in out.items()
           if not v <= next(t for key, t in tols.items() if key in k)}
    if bad:
        raise AssertionError(f"long-context paths off their plain versions: {bad}")
    return out


def fit_batch(reckon, cap, card_bytes):
    """The largest batch, at most ``cap``, whose reckoned peak
    (``reckon(batch)`` in bytes) fits ``FIT_SHARE`` of the card; the peak
    grows linearly with the batch, so two reckonings place it and a third
    checks it. Returns (batch, its reckoned peak)."""
    one, two = reckon(1), reckon(2)
    per = max(two - one, 1)
    batch = max(1, min(cap, int((FIT_SHARE * card_bytes - (one - per)) // per)))
    peak = reckon(batch)
    while batch > 1 and peak > FIT_SHARE * card_bytes:
        batch -= 1
        peak = reckon(batch)
    return batch, peak


def run_long_context(torch, kernels, none, card_bytes):
    """qwen3_0_6b at full width, ``LONG_LAYERS`` deep, stacked (``scan_layers=True``)
    under ``remat_policy="full"``, float32, at 32,768 tokens, through the dry
    run's step functions: (a) ``make_train_step`` with basis-rotation Adam
    (the arch's ``rotation_strategy``; B4 and B5 through the kernels,
    ``use_kernels=True``), batch 1, query-chunked attention and the chunked
    cross-entropy (``loss_chunk`` 2,048), ``LONG_STEPS`` steps (a refresh at
    step 0); layers are cut only if the dry run's reckoning of the step
    passes ``FIT_SHARE`` of the card; (b) ``make_prefill_step`` at the
    largest batch the dry run reckons under ``FIT_SHARE``, at most
    ``LONG_PREFILL_BATCH``; (c) ``make_serve_step`` at position 32,767 of a
    stacked decode_32k cache, its batch cut the same way (at most 128).
    Each part emits its line (``long_context_train``, ``_prefill``,
    ``_decode``) with its time, its peak beside the dry run's reckoned peak
    for the same config and (batch, seq), and its launches; every launch
    count is zeroed just before each part (each train step) and read just
    after. Returns the three parts."""
    import numpy as np

    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import Transformer, init_cache, param_leaves
    from repro_torch.optim.factory import build_optimizer

    arch, S = LONG_ARCH, LONG_SEQ
    full = get_config(arch).replace(**LONG_OVERRIDES)
    src, geom = dryrun.rotation_strategy(arch)

    def reckon(shape, batch, layers=full.num_layers):
        return dryrun.dryrun_one(arch, shape, overrides={**LONG_OVERRIDES, "num_layers": layers},
                                 verbose=False, use_kernels=True, batch=batch, seq=S,
                                 extrapolate=shape == "train_4k")

    out = {"arch": arch, "layers_full": full.num_layers, "seq": S,
           "overrides": LONG_OVERRIDES, "rotation": [src, geom], "card_bytes": card_bytes,
           "reduced": {"train_batch": "1 of prefill_32k's 32 (one card)",
                       "train_steps": f"{LONG_STEPS} of 2 (the script's time limit)"}}
    # (a) the train step: the reckoning first; more whole layers are cut
    # only if it does not fit
    t0 = time.perf_counter()
    layers = LONG_LAYERS
    r = reckon("train_4k", 1, layers)
    while r["peak_bytes_per_device"] > FIT_SHARE * card_bytes and layers > 1:
        layers -= 1
        r = reckon("train_4k", 1, layers)
    cfg = full.replace(num_layers=layers)
    out["layers"] = layers
    out["reduced"]["layers"] = (f"{layers} of {full.num_layers} (the script's time limit"
                                f"{'' if layers == LONG_LAYERS else '; then the reckoning'})")
    train = {"reckon_s": time.perf_counter() - t0, "batch": 1,
             "reckoned_peak_gb": r["peak_bytes_per_device"] / 1e9,
             "reckoned_flops": r["flops"], "reckoned_hbm_bytes": r["hbm_bytes"]}
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", seed=0, draw_device="cuda")
    params = param_leaves(model)
    opt = build_optimizer(OptimizerConfig(name="basis_rotation", rotation_source=src,
                                          rotation_geometry=geom, rotation_freq=10,
                                          total_steps=10_000),
                          params, cfg, num_stages=1, apply_delay=False, use_kernels=True)
    state = opt.init(params)
    step = dryrun.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    train["setup_s"] = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(1, S + 1))).to("cuda")
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, per_step, b5_calls = [], [], [], []
    for t in range(LONG_STEPS):
        zero_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with b5_in_place(b5_calls):
            model, state, loss = step(model, state, batch, t)
        losses.append(loss.item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(read_counts(kernels))
    train.update({"losses": losses, "step_s": step_s, "launches_per_step": per_step,
                  "b5_in_place_calls": len(b5_calls),
                  "tokens_per_s": S / statistics.median(step_s),
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    train["peak_minus_reckoned_gb"] = train["peak_mem_gb"] - train["reckoned_peak_gb"]
    want = {**none, "matmul": 4, "adam_scale": 1}
    if not all(math.isfinite(x) for x in losses) or any(c != want for c in per_step):
        raise AssertionError(f"long_context train: losses {losses}, launches {per_step} "
                             f"(a step should launch {want})")
    out["train"] = train
    emit({"phase": "long_context_train", **{k: v for k, v in out.items() if k != "train"},
          **train})
    # (b) and (c) each start from a fresh draw on an emptied allocator: the
    # train step's freed blocks would otherwise split (b)'s score blocks
    del opt, state, step, batch, params, model
    torch.cuda.empty_cache()

    def fresh_model():
        torch.cuda.empty_cache()
        return Transformer(cfg, device="cuda", seed=0, draw_device="cuda").requires_grad_(False)

    # (b) prefill at the largest batch the dry run reckons under the gate
    t0 = time.perf_counter()
    B, peak = fit_batch(lambda b: reckon("prefill_32k", b, layers)["peak_bytes_per_device"],
                        LONG_PREFILL_BATCH, card_bytes)
    out["reduced"]["prefill_batch"] = (f"{B}: at most {LONG_PREFILL_BATCH} of prefill_32k's "
                                       "32 (the script's time limit)")
    prefill = {"reckon_s": time.perf_counter() - t0, "batch": B,
               "reckoned_peak_gb": peak / 1e9}
    model = fresh_model()
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(B, S))).to("cuda")
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = dryrun.make_prefill_step(cfg)(model, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill.update({"s": prefill_s, "launches": read_counts(kernels),
                    "tokens_per_s": B * S / prefill_s,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "logits_shape": list(logits.shape),
                    "logits_finite": bool(torch.isfinite(logits).all())})
    prefill["peak_minus_reckoned_gb"] = prefill["peak_mem_gb"] - prefill["reckoned_peak_gb"]
    if tuple(logits.shape) != (B, cfg.vocab_size) or not prefill["logits_finite"]:
        raise AssertionError(f"long_context prefill: logits {prefill}")
    out["prefill"] = prefill
    emit({"phase": "long_context_prefill", "arch": arch, "layers": layers, "seq": S, **prefill})
    del logits, toks, model

    # (c) one decode step at the last position of a stacked 32,768-slot cache
    t0 = time.perf_counter()
    B, peak = fit_batch(lambda b: reckon("decode_32k", b, layers)["peak_bytes_per_device"],
                        128, card_bytes)
    decode = {"reckon_s": time.perf_counter() - t0, "batch": B, "pos": S - 1,
              "reckoned_peak_gb": peak / 1e9}
    model = fresh_model()
    cache = init_cache(cfg, B, S, device="cuda")
    decode["cache_gb"] = sum(v.numel() * v.element_size() for c in cache for v in c.values()) / 1e9
    token = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(B, 1))).to("cuda")
    serve = dryrun.make_serve_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    times = []
    for pos in (S - 2, S - 1):  # the first a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = serve(model, token, cache, pos)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    decode.update({"s": times[-1], "warmup_s": times[0], "launches": read_counts(kernels),
                   "tokens_per_s": B / times[-1],
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "logits_shape": list(logits.shape),
                   "logits_finite": bool(torch.isfinite(logits).all())})
    decode["peak_minus_reckoned_gb"] = decode["peak_mem_gb"] - decode["reckoned_peak_gb"]
    if tuple(logits.shape) != (B, 1, cfg.vocab_size) or not decode["logits_finite"]:
        raise AssertionError(f"long_context decode: logits {decode}")
    out["decode"] = decode
    emit({"phase": "long_context_decode", "arch": arch, "layers": layers, "seq": S, **decode})
    del model, cache, logits
    torch.cuda.empty_cache()
    return out


def start_dryruns():
    """The dry runs on the meta device, in subprocesses that see no card:
    ``launch.dryrun --all`` and ``launch.dryrun_pipeline`` under each
    schedule, each writing its rows under chiprun_out/. Returns the running
    processes and their output files."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    runs = []
    for name, args in (("dryrun_all", ["repro_torch.launch.dryrun", "--all"]),
                       *((f"dryrun_pipeline_{s}", ["repro_torch.launch.dryrun_pipeline",
                                                    "--schedule", s])
                         for s in ("fill_drain", "1f1b"))):
        rows = OUT_DIR / f"{name}.jsonl"
        rows.unlink(missing_ok=True)
        log = open(OUT_DIR / f"{name}.log", "w")
        proc = subprocess.Popen([sys.executable, "-m", *args, "--out", str(rows)], cwd=ROOT,
                                env=env, stdout=log, stderr=subprocess.STDOUT)
        runs.append((name, proc, rows, log, time.perf_counter()))
    return runs


def finish_dryruns(runs):
    """Wait for the dry runs (stopping any past ``DRYRUN_TIMEOUT``) and count
    their rows' statuses; every process must exit 0, the sweep must hold a
    row for every (arch, shape) and no row may be an error."""
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES

    out = {}
    for name, proc, rows, log, t0 in runs:
        try:
            rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        log.close()
        lines = [json.loads(x) for x in rows.read_text().splitlines()] if rows.exists() else []
        out[name] = {"rc": rc, "s": time.perf_counter() - t0, "rows": len(lines),
                     "status": dict(Counter(r["status"] for r in lines))}
        if name == "dryrun_all":
            out[name]["fits"] = sorted(f"{r['arch']}/{r['shape']}" for r in lines if r.get("fits"))
            want = len(ARCH_IDS) * len(INPUT_SHAPES)
            ok = [r for r in lines if r["status"] == "ok"]
            # one device of the reference's grid under the sharding rules
            out[name]["sharded_gb"] = {f"{r['arch']}/{r['shape']}": r["sharded"]["total_bytes"]
                                       / 1e9 for r in ok if "sharded" in r}
            if not all("sharded" in r and r["sharded"]["mesh"] == r["reference_mesh"]
                       and r["sharded"]["total_bytes"] > 0 for r in ok):
                raise AssertionError(f"{name}: an ok row without its sharded figures")
        else:
            row = lines[-1] if lines else {}
            out[name].update({k: row.get(k) for k in (
                "mesh", "processes", "argument_bytes", "temp_bytes", "peak_bytes", "sent_bytes",
                "reduce_bytes", "collectives", "compile_s")})
            want = 1
        if rc != 0 or len(lines) != want or out[name]["status"].get("error"):
            raise AssertionError(f"{name}: exit {rc}, {len(lines)} rows of {want}, "
                                 f"statuses {out[name]['status']}")
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


TAPES = {}  # a stream's key -> the host batches that its recorded run sampled


def stream_key(cfg, batch_size, seq_len, seed):
    return (cfg.vocab_size, cfg.num_codebooks, cfg.frontend, cfg.frontend_tokens,
            cfg.frontend_dim or cfg.d_model, batch_size, seq_len, seed)


@contextlib.contextmanager
def stream_tape(mode):
    """``"record"``: within, every draw of ``repro_torch.data.batches`` is
    the sampler's (a run's ``data_s`` is sampling and the copy to its
    device) and each batch is kept on the host. ``"replay"``: within, a run
    of a recorded stream draws the kept batches in order, each copied to its
    device (its ``data_s`` is the copy), and a draw past them raises. The
    values are the sampler's either way; each run's line says which it got
    (``data``). Only paths whose data time nothing reads replay."""
    from repro_torch import data as rdata

    sample = rdata.batches

    def recorded(cfg, batch_size, seq_len, seed=0, device="cuda"):
        tape = TAPES.setdefault(stream_key(cfg, batch_size, seq_len, seed), [])
        for i, b in enumerate(sample(cfg, batch_size, seq_len, seed=seed, device="cpu")):
            if i == len(tape):
                tape.append(b)
            yield {k: v.to(device) for k, v in b.items()}

    def replayed(cfg, batch_size, seq_len, seed=0, device="cuda"):
        key = stream_key(cfg, batch_size, seq_len, seed)
        for b in TAPES.get(key, []):
            yield {k: v.to(device) for k, v in b.items()}
        raise AssertionError(f"stream {key}: a replayed run read past the "
                             f"{len(TAPES.get(key, []))} recorded batches")

    rdata.batches = recorded if mode == "record" else replayed
    try:
        yield
    finally:
        rdata.batches = sample


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


def leaf_kind(path: str) -> str:
    """The kind of a parameter leaf, for memory by kind: ``mixer``, ``mlp``,
    ``norms``, ``embed`` (with the position embedding) or ``lm_head``. Takes
    the sim layout's paths (``blocks/3/mixer/w_q``) and the SPMD engine's
    (``0/mixer/w_q``, ``1/embed/embedding``)."""
    parts = path.split("/")
    if parts[0] in ("0", "1"):
        parts = parts[1:]
    if parts[0] == "blocks":
        parts = parts[2:]
    name = parts[0]
    return "norms" if "norm" in name else "embed" if name in ("embed", "pos_emb") else name


def rings_by_kind(opt_state, paths) -> dict:
    """Bytes of a delay wrapper's rings (gradients and weights) by the kind
    of the leaf each ring belongs to; ``paths`` are the leaves in order."""
    out = Counter()
    for name in ("grad_q", "param_q"):
        for path, q in zip(paths, opt_state.get(name, ())):
            if q is not None:
                out[leaf_kind(path)] += q.numel() * q.element_size()
    return dict(out)


def expected_rings_by_kind(cfg, stages, data_delay=0, stacked=False) -> dict:
    """The gradient rings' bytes by leaf kind that the staleness requires,
    from the parameter shapes alone, not from the optimizer: one float32
    slot per step of delay. A leaf on stage s of K has tau = K-1-s (layers
    split evenly and in order, stage 0 holds the input embeddings and
    projection, the last stage the final norm and the head). Sim
    (per-layer leaves): each leaf's ring holds tau + D slots. SPMD
    (``stacked``): a stacked block leaf's ring holds K-1 slots of all its
    stages whatever D (the deferred reduction deepens only weight rings),
    a shared leaf's its own tau."""
    from repro_torch.models import Transformer, param_leaves

    cfg = cfg.replace(scan_layers=False)
    K, per = stages, max(1, cfg.num_layers // stages)
    out = Counter()
    for path, p in param_leaves(Transformer(cfg, device="meta", seed=None)).items():
        parts = path.split("/")
        if parts[0] == "blocks":
            slots = K - 1 if stacked else K - 1 - min(int(parts[1]) // per, K - 1) + data_delay
        else:
            tau = K - 1 if parts[0] in ("embed", "pos_emb", "frontend_proj") else 0
            slots = tau if stacked else tau + data_delay
        if slots:
            out[leaf_kind(path)] += 4 * slots * p.numel()
    return dict(out)


def peak_probe(torch, engine) -> list:
    """Splits each SPMD step's peak memory at the replicas' local
    gradients: wraps ``engine.local_grad_fn`` so that the peak counter is
    read and reset just before it (the peak of the previous step's reduce,
    FIFO, clip and optimizer update; at the first step, of the run's start)
    and just after it (the peak inside the replicas' schedules and the
    sum of their gradients). Returns the list each step's reading joins."""
    marks, real = [], engine.local_grad_fn

    def local_grad_fn(*a):
        torch.cuda.synchronize()
        mark = {"allocated_before_gb": torch.cuda.memory_allocated() / 1e9,
                "peak_before_gb": torch.cuda.max_memory_allocated() / 1e9}
        torch.cuda.reset_peak_memory_stats()
        out = real(*a)
        torch.cuda.synchronize()
        mark["peak_in_local_grads_gb"] = torch.cuda.max_memory_allocated() / 1e9
        mark["allocated_after_gb"] = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        marks.append(mark)
        return out

    engine.local_grad_fn = local_grad_fn
    return marks


def reckon_sim(cfg, stages, data_delay=0, replicas=None, optimizer="basis_rotation",
               batch=0, seq=0, stage_slab=None):
    """What a sim step of ``cfg`` on ``stages`` stages must hold, in bytes
    by kind, from the optimizer that the launcher builds for ``optimizer``
    (basis rotation with the launcher's defaults and the kernels' grouped
    step, or Adam), initialised over the model's meta-device parameters
    (nothing is allocated): float32 masters and their gradients, Adam's m
    and v, the bases U, V and grams L, R of basis rotation, and the delay
    rings (also by leaf kind). Beside them, the transients of the update at
    its peak: basis rotation's grouped rotation (U^T [G, M] and [G, M] V
    both alive: four floats per rotated element); Adam's updates (one float
    per parameter, every leaf's but the last) and three float temporaries
    of the largest leaf. With ``batch`` and ``seq``, also the activations
    that outgrow the rest at long sequences: the sim path's dense attention
    keeps each layer's (B, H, S, S) float32 probabilities for the backward,
    and three more such tensors live while one layer's are formed or
    differentiated, S being the text plus the frontend prefix; the Mamba
    scan keeps two (B, S, d_inner, d_state) float32 tensors a Mamba layer
    (dA and the states, ``models/mamba.py``), and two more (the states'
    and dA's gradients) live while one layer's scan is differentiated; and
    the float32 logits, their log-softmax and its gradient over the text. The
    peak is the state plus the larger of the update's transients and the
    activations; nothing else (the MLP's activations, the allocator's
    blocks) is counted. ``data_delay`` D deepens every ring by D slots
    (``--data-async --data-delay D``). With ``replicas`` R, the SPMD
    engine's step instead (stacked leaves, stage rings, weight queues D
    deeper for delay compensation), and beside its state the D deferred
    reductions of its FIFO and, for R > 1, the running sum of the
    replicas' local gradients, each a float32 copy of the parameters. ``stage_slab=(k0, k1)`` (with
    ``replicas``) reckons one process of a multi-process SPMD run that
    holds those stages: its slab of the stacked leaves and every shared
    leaf (``engine.spmd.slab_optimizer``), the R being its own replicas."""
    from repro_torch.analysis import state_leaves
    from repro_torch.configs import OptimizerConfig
    from repro_torch.core.layout import build_layout
    from repro_torch.engine.spmd import (
        SpmdEngine,
        opt_leaves,
        slab_optimizer,
        stack_stage_params,
    )
    from repro_torch.launch.topology import Topology
    from repro_torch.models import Transformer, param_leaves
    from repro_torch.optim.factory import build_optimizer

    cfg = cfg.replace(scan_layers=False)
    ocfg = OptimizerConfig(name=optimizer)
    params = param_leaves(Transformer(cfg, device="meta", seed=None))
    if replicas is None:
        opt = build_optimizer(ocfg, params, cfg, num_stages=stages, use_kernels=True,
                              data_delay=data_delay)
    elif stage_slab is not None:
        opt, st, sh = slab_optimizer(cfg, ocfg, stages, stage_slab, data_delay=data_delay,
                                     use_kernels=True)
        params = opt_leaves(st, sh)
    else:
        opt = SpmdEngine(cfg, ocfg, stages, device="meta", use_kernels=True,
                         topology=Topology(stages=stages, data=replicas),
                         data_async=data_delay > 0, data_delay=data_delay).opt
        params = opt_leaves(*stack_stage_params(params, cfg, stages))
    kind = {"m": "adam", "v": "adam", "U": "bases", "V": "bases", "L": "grams", "R": "grams"}
    out = Counter()
    state = opt.init(params)
    for path, x in state_leaves(state).items():
        parts = path.split("/")
        if parts[0] != "inner":
            key = "delay_rings"
        else:  # basis rotation: inner/leaves/i/<m|v|U|V|L|R>; Adam: inner/<m|v>/<leaf>
            key = kind[parts[-1] if parts[1] == "leaves" else parts[1]]
        out[key] += x.numel() * x.element_size()
    nparams = sum(p.numel() for p in params.values())
    out["masters"] = out["gradients"] = 4 * nparams
    if replicas is not None:
        out["data_fifo"] = 4 * nparams * data_delay
        # the running sum of the replicas' local gradients beside the one
        # being computed (counted under gradients)
        out["local_gradients"] = 4 * nparams if replicas > 1 else 0
    rotated = sum(math.prod(pl.shape) for pl in build_layout(params, "bilateral") if pl.rotate)
    if optimizer == "basis_rotation":
        transient = 16 * rotated
    else:
        largest = max(p.numel() for p in params.values())
        transient = 4 * (nparams - largest) + 12 * largest
    activations = {}
    if batch:
        S = seq + cfg.frontend_tokens
        mixers = Counter(cfg.pattern[l % len(cfg.pattern)].mixer for l in range(cfg.num_layers))
        attn_layers, mamba_layers = mixers["attn"], mixers["mamba"]
        scan = (4 * batch * S * cfg.ssm.expand * cfg.d_model * cfg.ssm.d_state
                if mamba_layers else 0)
        activations = {
            "dense_attention": (4 * batch * cfg.attention.num_heads * S * S * (attn_layers + 3)
                                if attn_layers else 0),
            "mamba_scan": scan * (2 * mamba_layers + 2),
            "logits": 3 * 4 * batch * seq * cfg.num_codebooks * cfg.vocab_size}
    held = sum(out.values())
    return {"layers": cfg.num_layers, "params": nparams, "rotated_params": rotated,
            "optimizer": optimizer, "data_delay": data_delay, "replicas": replicas,
            "stage_slab": stage_slab,
            "batch": batch, "seq": seq, "bytes": dict(out),
            "delay_rings_by_kind": rings_by_kind(state, list(params)),
            "held_bytes": held, "update_transient_bytes": transient,
            "activation_bytes": activations,
            "reckoned_peak_bytes": held + max(transient, sum(activations.values()))}


def launch_shape(args):
    """(stages, data delay, optimizer, seq) of the launcher's run for
    ``args``, read as the launcher reads them."""
    from repro_torch.launch import train

    ns = train.parse_args(args)
    return ns.stages, train.data_delay_of(ns), ns.optimizer, ns.seq


def fit_sim(cfg, args, card_bytes, batches=(0,)):
    """The launcher's sim path for ``args`` over ``cfg``, cut to fit
    ``FIT_SHARE`` of the card: the most layers, in multiples of its stage
    count (at least one multiple), whose reckoning at the smallest of
    ``batches`` fits; then the largest of ``batches`` that fits beside
    them (batch 0 counts no activations). Stages, data delay, optimizer and
    sequence are read from ``args``; widths are never cut. Returns (layers,
    batch, reckoning at both)."""
    stages, data_delay, optimizer, seq = launch_shape(args)

    def reckon(layers, batch):
        return reckon_sim(cfg.replace(num_layers=layers), stages, data_delay,
                          optimizer=optimizer, batch=batch, seq=seq)

    def fits(r):
        return r["reckoned_peak_bytes"] <= FIT_SHARE * card_bytes

    lo, hi = 1, cfg.num_layers // stages  # multiples of the stage count
    while lo < hi:  # the reckoning grows with depth: bisect for the deepest that fits
        mid = (lo + hi + 1) // 2
        if fits(reckon(mid * stages, min(batches))):
            lo = mid
        else:
            hi = mid - 1
    layers = lo * stages
    for batch in sorted(batches, reverse=True):
        r = reckon(layers, batch)
        if fits(r) or batch == min(batches):
            return layers, batch, r


# (key, arch, launcher args, batches fit_sim may choose from): the catalog's
# wide configs on the sim path
FRONTEND_MOE = (("llava", "llava_next_34b", LLAVA_ARGS, LLAVA_BATCHES),
                ("musicgen", "musicgen_large", MUSICGEN_ARGS, (8,)),
                ("mixtral", "mixtral_8x22b", MIXTRAL_ARGS, (8,)),
                ("jamba", "jamba_v0_1_52b", JAMBA_ARGS, (8,)))


def frontend_moe_fits(get_config, total):
    """``fit_sim`` of each of the four paths on a card of ``total`` bytes:
    {key: (layers, batch, reckoning)}."""
    return {key: fit_sim(get_config(arch), args, total, batches)
            for key, arch, args, batches in FRONTEND_MOE}


def frontend_moe_paths(train, torch, kernels, fits, paths, total):
    """The frontends, the MoE MLP and the Mamba hybrid at full width on the
    sim path, each through the launcher, cut as ``fits`` says, with its
    reckoning printed before its run and beside its peak after (and the
    peak's distance from it): per step four B4 launches and one B5 launch
    on basis rotation's leaves (``paths[key]``: the step's B4 groups and B5
    leaves), none for mixtral's Adam, whose basis-rotation reckoning is
    printed beside its own. Returns {key: run}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import adam_step as kadam

    out = {}
    for key, arch, args, _ in FRONTEND_MOE:
        layers, batch, reckon = fits[key]
        cfg_full = get_config(arch)
        n = int(args[args.index("--steps") + 1])
        line = {"phase": f"{key}_reckoning", "arch": arch, "card_bytes": total,
                "gate_bytes": FIT_SHARE * total, "layers": layers,
                "layers_full": cfg_full.num_layers, "batch": batch,
                "frontend_tokens": cfg_full.frontend_tokens, **reckon}
        if key == "mixtral":
            stages, data_delay, _, seq = launch_shape(args)
            line["basis_rotation"] = reckon_sim(cfg_full.replace(num_layers=layers), stages,
                                                data_delay, batch=batch, seq=seq)
        emit(line)
        want = {k: 0 for k in kernels}
        if key in paths:
            groups, leaves = paths[key]
            want.update(matmul=n * sum(1 for g in groups if g),
                        adam_scale=n * -(-len(leaves) // kadam.MAX_LEAVES))
        torch.cuda.empty_cache()
        with swapped_config(arch, lambda c, layers=layers: c.replace(num_layers=layers)):
            run = run_path(train, torch, kernels, args + ["--batch", str(batch)], want)
        run.update(layers=layers, batch=batch,
                   launches_per_step={k: v / n for k, v in run["launches"].items()},
                   peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
                   reckoned_peak_gb=reckon["reckoned_peak_bytes"] / 1e9,
                   peak_minus_reckoned_gb=run["peak_mem_gb"] - reckon["reckoned_peak_bytes"] / 1e9,
                   reckoned_gb={k: v / 1e9 for k, v in reckon["bytes"].items()},
                   reckoned_activation_gb={k: v / 1e9
                                           for k, v in reckon["activation_bytes"].items()},
                   gate_gb=FIT_SHARE * total / 1e9)
        out[key] = run
        emit({"phase": f"{key}_sim", "arch": arch, **run})
        torch.cuda.empty_cache()
    return out


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


def run_baseline(train, torch, kernels, args, batch_list, want, first_loss=None,
                 rings=False, probe=None):
    """One run through the launcher's trainer with the phase's batches in
    place of its stream; every launch count zeroed just before and read just
    after. Checks finite losses, the launches, and the first loss against
    ``first_loss`` (the same weights and batch, before any update) where one
    is given. For delay compensation also reports its weight queues' bytes;
    with ``rings``, the delay rings' bytes by leaf kind, as allocated. With
    ``probe(torch, engine)`` (``peak_probe``), its readings under
    ``peak_split`` and the peak as the largest of them and the last."""
    from repro_torch.engine import run_loop
    from repro_torch.engine.spmd import opt_leaves

    steps = int(args[args.index("--steps") + 1])
    engine, _, loop_cfg = train.build(train.parse_args(args))
    marks = probe(torch, engine) if probe else None
    held = [engine.init_state()]
    opt_state = held[0].opt_state
    param_q = tensor_bytes(opt_state["param_q"]) if "param_q" in opt_state else None
    by_kind = None
    if rings:
        params = held[0].params
        by_kind = rings_by_kind(opt_state, list(
            opt_leaves(*params) if isinstance(params, tuple) else params))
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
    peak = torch.cuda.max_memory_allocated() / 1e9
    if marks is not None:
        marks.append({"peak_before_gb": peak})  # the last step's reduce and update
        peak = max(v for m in marks for k, v in m.items() if k.startswith("peak"))
    return {"losses": losses, "launches": launches, "first_loss_diff": first_diff,
            "step_s": timings.step_s, "median_step_s_no_refresh": statistics.median(
                timings.step_s[1:]), "wall_s": wall, "peak_mem_gb": peak,
            **({"peak_split": marks} if marks is not None else {}),
            **({"param_q_bytes": param_q} if param_q is not None else {}),
            **({"delay_rings_by_kind": by_kind} if rings else {})}


def check_data_async(train, torch, kernels, cfg, sim_per_step, sgroups, sadam_per_step):
    """The asynchronous data axis at full width. Sim: the path of phase 3
    for DATA_ASYNC_STEPS steps without the flags and with --data-async at
    each data delay D (every leaf's ring D slots deeper; D = 0 must give the
    same bits as no flag), the rings' bytes by leaf kind as allocated
    against ``expected_rings_by_kind``. SPMD: the 1F1B path of phase 4 with
    R = 2 data replicas (each its row of every 2-row microbatch, so B1-B3
    launch R times as often) and a reduction D = 2 steps old; its rings
    against the formula, its peak beside the state, the FIFO and the local
    gradients reckoned, and split at the local gradients. One list of
    batches sampled once, the sim runs on the first 8 rows of each; returns
    the phase's line and that list."""
    from itertools import islice

    from repro_torch.data import batches as data_batches

    none = {k: 0 for k in kernels}
    K = int(SPMD_ARGS[SPMD_ARGS.index("--stages") + 1])
    M = int(SPMD_ARGS[SPMD_ARGS.index("--microbatches") + 1])
    L = cfg.num_layers
    t_phase = time.perf_counter()
    n, spec = DATA_ASYNC_STEPS, DATA_ASYNC_SPMD
    big = list(islice(data_batches(cfg, spec["batch"], 256, seed=0, device="cuda"), n))
    small = [{k: v[:8] for k, v in b.items()} for b in big]
    data_async = {"sample_s": time.perf_counter() - t_phase, "sim": {}}
    sim_args = list(MAIN_ARGS)
    sim_args[sim_args.index("--steps") + 1] = str(n)
    for dd in (None,) + DATA_ASYNC_SIM_DELAYS:
        torch.cuda.empty_cache()
        flags = [] if dd is None else ["--data-async", "--data-delay", str(dd)]
        first = None if dd is None else data_async["sim"]["no_flags"]["losses"][0]
        run = run_baseline(train, torch, kernels, sim_args + flags, small,
                           {k: n * c for k, c in sim_per_step.items()}, first, rings=True)
        reckon = reckon_sim(cfg, K, data_delay=dd or 0)
        expected = expected_rings_by_kind(cfg, K, data_delay=dd or 0)
        if run["delay_rings_by_kind"] != expected:
            raise AssertionError(f"data delay {dd}: rings {run['delay_rings_by_kind']} against "
                                 f"the (tau + D) x numel x 4 formula's {expected}")
        run["reckoned_gb"] = {k: v / 1e9 for k, v in reckon["bytes"].items()}
        run["reckoned_held_gb"] = reckon["held_bytes"] / 1e9
        run["reckoned_peak_gb"] = reckon["reckoned_peak_bytes"] / 1e9
        data_async["sim"]["no_flags" if dd is None else f"data_delay_{dd}"] = run
    if data_async["sim"]["data_delay_0"]["losses"] != data_async["sim"]["no_flags"]["losses"]:
        raise AssertionError(f"--data-async --data-delay 0: {data_async['sim']['data_delay_0']}"
                             f" against no flags {data_async['sim']['no_flags']}")
    torch.cuda.empty_cache()
    R, dd = spec["replicas"], spec["delay"]
    spmd_args = SPMD_ARGS + ["--schedule", "1f1b", "--steps", str(n), "--data-par", str(R),
                             "--data-async", "--data-delay", str(dd)]
    spmd_args[spmd_args.index("--batch") + 1] = str(spec["batch"])
    run = run_baseline(train, torch, kernels, spmd_args, big, {
        **none, "flash_fwd": n * 2 * R * M * L, "flash_bwd_dq": n * R * M * L,
        "flash_bwd_dkv": n * R * M * L, "matmul": n * sum(1 for g in sgroups if g),
        "adam_scale": n * sadam_per_step}, rings=True, probe=peak_probe)
    reckon = reckon_sim(cfg, K, data_delay=dd, replicas=R)
    expected = expected_rings_by_kind(cfg, K, data_delay=dd, stacked=True)
    if run["delay_rings_by_kind"] != expected:
        raise AssertionError(f"spmd: rings {run['delay_rings_by_kind']} against the "
                             f"(K-1 stacked, tau shared) x numel x 4 formula's {expected}")
    run["reckoned_gb"] = {k: v / 1e9 for k, v in reckon["bytes"].items()}
    run["reckoned_held_gb"] = reckon["held_bytes"] / 1e9
    run["launches_per_step"] = {k: v / n for k, v in run["launches"].items() if v}
    data_async["spmd_1f1b"] = run
    data_async["phase_s"] = time.perf_counter() - t_phase
    return data_async, big


def spawn_start(tag, extra, train_args):
    """Start ``python -m repro_torch.launch.spawn`` with ``extra`` and
    ``train_args`` from the checkout's root, its output going to
    ``chiprun_out/spawn_<tag>.log``; ``spawn_wait`` ends it."""
    cmd = [sys.executable, "-m", "repro_torch.launch.spawn", "--timeout", str(SPAWN_TIMEOUT),
           *extra, "--", *train_args]
    log = OUT_DIR / f"spawn_{tag}.log"
    with open(log, "w") as f:
        f.write(" ".join(cmd) + "\n")
        f.flush()
        # a session of its own, so that ``spawn_stop`` can end its workers too
        proc = subprocess.Popen(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                                stdout=f, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
    return tag, proc, log, time.perf_counter()


def spawn_stop(run):
    """Kill a ``spawn_start``'s launcher and its workers if still running."""
    proc = run[1]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def spawn_wait(run):
    """(output, wall seconds) of a ``spawn_start``; raises unless it exits 0.
    A spawn past its own timeout is killed."""
    tag, proc, log, t0 = run
    try:
        rc = proc.wait(timeout=SPAWN_TIMEOUT + 60)
    except subprocess.TimeoutExpired:
        spawn_stop(run)
        rc = proc.returncode
    wall = time.perf_counter() - t0
    text = log.read_text()
    if rc != 0:
        raise AssertionError(f"spawn {tag} exited {rc}: {text[-4500:]}")
    return text, wall


def rank_lines(stats_dir, reckon):
    """Per rank of a spawned run: launches a step, step and data times, peak
    memory beside the reckoning of its slab, bytes sent a step, barrier waits."""
    out = []
    for f in sorted(Path(stats_dir).glob("rank*.json")):
        st = json.loads(f.read_text())
        n = max(st["steps"], 1)
        r = reckon(tuple(st["stages"]), tuple(st["data_shards"]))
        out.append({"rank": st["rank"], "stages": st["stages"],
                    "data_shards": st["data_shards"], "transport": st["transport"],
                    "launches_per_step": {k: v / n for k, v in st["launches"].items() if v},
                    "setup_s": st["setup_s"], "step_s": st["step_s"], "data_s": st["data_s"],
                    "median_step_s": statistics.median(st["step_s"]),
                    "median_data_s": statistics.median(st["data_s"]),
                    "peak_mem_gb": st["peak_mem_bytes"] / 1e9,
                    "reckoned_peak_gb": r["reckoned_peak_bytes"] / 1e9,
                    "reckoned_held_gb": r["held_bytes"] / 1e9,
                    "bytes_sent_per_step": None if st["bytes_sent"] is None
                    else st["bytes_sent"] / n,
                    "barrier_s": st["barrier_s"], "start_step": st["start_step"]})
    return out


def check_spawn_spmd(train, torch, kernels, cfg, phase4_1f1b, sgroups, sadam_per_step,
                     pods_batches):
    """The multi-process SPMD path: phase 4's full-width 1F1B run over two
    ranks of ``repro_torch.launch.spawn`` that share the card over gloo
    (rank 0 stages 0-3, rank 1 stages 4-7). (a) and (b) in one launch:
    SPAWN_STEPS steps checkpointing every step, rank 1 killed once step
    SPAWN_CUT commits, resumed on 2 ranks: the merged series within
    SPAWN_TOL of phase 4's uninterrupted one-process losses; per rank of the
    resumed launch (uninterrupted from step SPAWN_CUT on) its launches a
    step, B1-B3 summing to phase 4's 2 M L / M L / M L, step and data times,
    peak beside its slab's reckoning, bytes sent, barrier waits. (c) --pods
    2 --data-par 1 at batch 16 over the two ranks (each rank every stage of
    one data replica) against the one-process --pods 2 run of the same
    batches (``pods_batches``, sampled once by ``data_async``; the
    in-process data axis, run here while (c) runs) within SPAWN_TOL, killed
    after the step-SPAWN_PODS_CUT checkpoint and resumed as one process on
    (stages=8): finite, and within SPAWN_CONTINUITY_TOL of the one-process
    run's losses; only its wall time is reported. (c) runs first; (a)/(b)
    starts when (c)'s first launch ends, so that (c)'s one resumed process
    shares the card with (a)/(b)'s first launch, whose times nothing reads
    (``c.ended_s`` and ``a_b.started_s`` say how far they overlapped). With
    two or more cards,
    (a) again with one rank a card over NCCL; with one, a line says it was
    not run."""
    t_phase = time.perf_counter()
    M, L = 8, cfg.num_layers
    base = SPMD_ARGS + ["--schedule", "1f1b", "--steps", str(SPAWN_STEPS)]
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_spawn_"))
    full = reckon_sim(cfg, 8, replicas=1)
    disk = shutil.disk_usage(work)
    print(json.dumps({"disk_usage": {"path": str(work), "free": disk.free,
                                     "state_bytes": full["held_bytes"]}}), flush=True)
    # (b) and (c) may overlap, each keeping up to two checkpoints of the state
    if disk.free < 4 * full["held_bytes"]:
        raise AssertionError(f"{work}: {disk.free} bytes free; the spawned checkpoints need "
                             f"four times the state's {full['held_bytes']}")

    reckoned = {}

    def reckon(stages, shards):  # the rank's slab: its stages, its data replicas
        key = (stages, shards[1] - shards[0])
        if key not in reckoned:
            reckoned[key] = reckon_sim(cfg, 8, replicas=key[1], stage_slab=stages)
        return reckoned[key]

    out, runs = {"work_dir": str(work)}, []
    try:
        # (c) first: the data axis over the ranks, then one process on
        # (stages=8). Its one-process reference runs here meanwhile, and
        # (a)/(b) starts once (c)'s first launch has ended
        c_base = list(base)
        c_base[c_base.index("--batch") + 1] = "16"
        c_base[c_base.index("--steps") + 1] = str(SPAWN_PODS_STEPS)
        pods = ["--pods", "2", "--data-par", "1"]
        tail = ["--ckpt-dir", str(work / "ckpt_c"), "--ckpt-every", str(SPAWN_PODS_CUT),
                "--out", str(work / "c.json")]
        c2 = c_base + tail + ["--rank-stats", str(work / "c_resumed")]
        run_c = spawn_start("c", ["--procs", "2", "--kill-pod-at", str(SPAWN_PODS_CUT),
                                  "--grace", "5", "--resume-procs", "1", "--resume-with",
                                  " ".join(c2)], c_base + pods + tail)
        runs.append(run_c)
        R, n = 2, SPAWN_PODS_STEPS
        one = run_baseline(train, torch, kernels, c_base + pods, pods_batches[:n], {
            **{k: 0 for k in kernels}, "flash_fwd": n * 2 * R * M * L,
            "flash_bwd_dq": n * R * M * L, "flash_bwd_dkv": n * R * M * L,
            "matmul": n * sum(1 for g in sgroups if g), "adam_scale": n * sadam_per_step})
        torch.cuda.empty_cache()
        deadline = time.perf_counter() + SPAWN_TIMEOUT
        while (run_c[1].poll() is None and time.perf_counter() < deadline
               and "[spawn] phase 2" not in run_c[2].read_text()):
            time.sleep(0.5)

        # (a) and (b): the stage split, killed after step SPAWN_CUT's
        # checkpoint and resumed on 2 ranks
        b_args = base + ["--ckpt-dir", str(work / "ckpt_b"), "--ckpt-every", "1",
                         "--out", str(work / "b.json"), "--rank-stats", str(work / "b")]
        run_b = spawn_start("b", ["--procs", "2", "--kill-pod-at", str(SPAWN_CUT), "--grace",
                                  "5", "--resume-procs", "2", "--resume-with", " ".join(b_args)],
                            b_args)
        runs.append(run_b)
        b_started = time.perf_counter() - t_phase

        stdout, wall = spawn_wait(run_c)
        merged = json.loads((work / "c.json").read_text())["losses"]
        start = json.loads((work / "c_resumed" / "rank0.json").read_text())["start_step"]
        cdiff = max(abs(x - y) for x, y in zip(merged[:start], one["losses"]))
        cont = max(abs(x - y) for x, y in zip(merged[start:], one["losses"][start:]))
        if ("resumed from" not in stdout or len(merged) != SPAWN_PODS_STEPS or start < 1
                or cdiff > SPAWN_TOL or not all(math.isfinite(x) for x in merged)
                or cont > SPAWN_CONTINUITY_TOL):
            raise AssertionError(f"spawn (c): merged {merged} (resumed at {start}) against the "
                                 f"one-process --pods 2 run's {one['losses']}")
        out["c"] = {"losses": merged, "one_process_losses": one["losses"],
                    "max_abs_diff_before_kill": cdiff, "resumed_at": start,
                    "resumed_max_abs_diff_to_one_process": cont, "wall_s": wall,
                    "ended_s": time.perf_counter() - t_phase}
        shutil.rmtree(work / "ckpt_c", ignore_errors=True)

        stdout, wall = spawn_wait(run_b)
        losses = json.loads((work / "b.json").read_text())["losses"]
        diff = max(abs(x - y) for x, y in zip(losses, phase4_1f1b))
        ranks = rank_lines(work / "b", reckon)
        sums = {k: sum(r["launches_per_step"].get(k, 0) for r in ranks)
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        want = {"flash_fwd": 2 * M * L, "flash_bwd_dq": M * L, "flash_bwd_dkv": M * L}
        if ("resumed from" not in stdout or len(losses) != SPAWN_STEPS or diff > SPAWN_TOL
                or sums != want or len(ranks) != 2
                or any(r["start_step"] != SPAWN_CUT for r in ranks)):
            raise AssertionError(f"spawn (a)/(b): merged losses {losses} against phase 4's "
                                 f"{phase4_1f1b} (max abs diff {diff}), B1-B3 a step {sums} "
                                 f"!= {want}, ranks {ranks}")
        for r in ranks:
            k = r["launches_per_step"]
            if k.get("matmul") != sum(1 for g in sgroups if g) or \
                    k.get("adam_scale") != sadam_per_step:
                raise AssertionError(f"spawn (a) rank {r['rank']}: launches {k}")
        out["a_b"] = {"args": " ".join(b_args), "cut": SPAWN_CUT, "losses": losses,
                      "phase4_losses": phase4_1f1b, "max_abs_diff": diff,
                      "b1_b3_per_step_sum": sums, "wall_s": wall, "started_s": b_started,
                      "ranks": ranks,
                      "transport_lines": [ln for ln in stdout.splitlines()
                                          if "transport=" in ln]}
        shutil.rmtree(work / "ckpt_b", ignore_errors=True)

        # NCCL, one rank a card, where there are cards for it
        cards = torch.cuda.device_count()
        if cards >= 2:
            n_args = base + ["--transport", "nccl", "--out", str(work / "n.json"),
                             "--rank-stats", str(work / "n")]
            _, wall = spawn_wait(spawn_start("nccl", ["--procs", "2"], n_args))
            nl = json.loads((work / "n.json").read_text())["losses"]
            ndiff = max(abs(x - y) for x, y in zip(nl, phase4_1f1b))
            if ndiff > SPAWN_TOL:
                raise AssertionError(f"spawn nccl: losses {nl} against {phase4_1f1b}")
            out["nccl"] = {"losses": nl, "max_abs_diff": ndiff, "wall_s": wall,
                           "ranks": rank_lines(work / "n", reckon)}
        else:
            out["nccl"] = None
            print(json.dumps({"spawn_spmd_nccl": "not run", "why": f"{cards} card(s): the "
                              "NCCL transport needs a card per rank"}), flush=True)
    finally:
        for run in runs:  # a check that failed leaves no spawn running
            spawn_stop(run)
        shutil.rmtree(work, ignore_errors=True)
        # what was measured, also when a check failed
        (OUT_DIR / "spawn_spmd.json").write_text(json.dumps(out, indent=1))
    out["reckoned_whole_state_gb"] = full["held_bytes"] / 1e9
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def data_async_cuda_vs_cpu(train):
    """Phase 5's pairs of the asynchronous data axis at smoke size: the sim
    path's deeper rings with Adam, and two data replicas with a deferred
    reduction on the 1F1B path, Adam and basis rotation, under the gates of
    the other pairs."""
    for backend, opts in (
            (["--backend", "sim", "--data-async", "--data-delay", "2"],
             ((["--optimizer", "adam"], 1e-4, 1e-4),)),
            (["--backend", "spmd", "--schedule", "1f1b", "--data-par", "2", "--data-async",
              "--data-delay", "1"],
             ((["--optimizer", "adam"], 1e-4, 1e-4), (["--use-kernels"], 2e-3, 5e-2)))):
        for opt, first2_tol, all_tol in opts:
            args = SMOKE_ARGS + backend + opt
            gpu = train.main(args)["losses"]
            cpu = train.main(args + ["--device", "cpu"])["losses"]
            diffs = [abs(a - b) for a, b in zip(gpu, cpu)]
            if not (len(diffs) == len(cpu) and max(diffs[:2]) < first2_tol
                    and max(diffs) < all_tol):
                raise AssertionError(f"{args}: cuda vs cpu losses differ: {gpu} vs {cpu}")
            emit({"phase": "cuda_vs_cpu", "args": " ".join(args), "cuda": gpu, "cpu": cpu,
                  "max_diff_first2": max(diffs[:2]), "max_diff": max(diffs)})


def main() -> int:
    # the long-context phase allocates and frees 28 GiB score blocks, which
    # split the caching allocator's fixed segments until one such block no
    # longer fits beside the reckoned peak; expandable segments map the same
    # bytes without that loss (set before the first CUDA allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    # ptxas's registers and spills per kernel, from the build's log
    from repro_torch.launch.bench_flash import ptxas_report
    from repro_torch.launch.roofline import card_peaks

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
    part, peaks = card_peaks(name)  # the part's published peaks, by the device's name

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

    # the dry runs on the host (meta device, no card), one core each, behind
    # every phase up to the long-sequence ones, which read them
    dryruns = start_dryruns()

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
    # the frontend and MoE paths, cut to fit the card (``fit_sim``, from the
    # reckoning alone): llava's 7168- and 20480-sided bases (B4's contraction
    # reaches K = 20480) and musicgen's 2048- and 8192-sided ones
    total = torch.cuda.get_device_properties(0).total_memory
    fits = frontend_moe_fits(get_config, total)
    lgroups, ladam_leaves = path_groups(get_config("llava_next_34b").replace(
        num_layers=fits["llava"][0]))
    mgroups, madam_leaves = path_groups(get_config("musicgen_large").replace(
        num_layers=fits["musicgen"][0]))
    # jamba's sim path: the Mamba projections' 288- and 256-sided bases and
    # in_proj's 16384-sided one beside the MLP's 14336-sided ones
    jcfg = get_config("jamba_v0_1_52b").replace(num_layers=fits["jamba"][0])
    jgroups, jadam_leaves = path_groups(jcfg)
    # the long-context train step's: qwen3_0_6b's seven rotated leaf kinds,
    # each stacked over its LONG_LAYERS layers (one batched problem a leaf)
    lcgroups, lcadam_leaves = path_groups(get_config(LONG_ARCH).replace(
        **LONG_OVERRIDES, num_layers=LONG_LAYERS), 1)
    mm_counts, smm_counts = product_counts(groups), product_counts(sgroups)
    check_s = {}  # host seconds of each of phase 2's checks

    def timed(key, check, *args):
        t0 = time.perf_counter()
        out = check(*args)
        check_s[key] = time.perf_counter() - t0
        return out

    mm_rows, mm_err = timed("matmul", check_matmul, torch, kmm, peaks)
    grp_rows, grp_err = timed("matmul_grouped", check_matmul_groups, torch, kmm, {
        "sim": groups, "spmd": sgroups, "xlstm_sim": xgroups, "paper_1b_sim": pgroups,
        "llava_sim": lgroups, "musicgen_sim": mgroups, "jamba_sim": jgroups,
        "long_context": lcgroups}, peaks)
    mm_err = max(mm_err, grp_err)
    adam_rows, adam_err = timed("adam", check_adam, torch, kadam)
    agrp_rows, agrp_err = timed("adam_grouped", check_adam_groups, torch, kadam, {
        "sim": adam_leaves, "spmd": sadam_leaves, "xlstm_sim": xadam_leaves,
        "paper_1b_sim": padam_leaves, "llava_sim": ladam_leaves,
        "musicgen_sim": madam_leaves, "jamba_sim": jadam_leaves,
        "long_context": lcadam_leaves}, peaks)
    adam_err = max(adam_err, agrp_err)
    flash_rows, flash_errs, flash_t = timed("flash", check_flash, torch, kflash, peaks)
    bf16_rows, bf16_errs, bf16_t = timed("flash_bf16", check_flash_bf16, torch, kflash, peaks)
    # head dim 128 at qwen3_0_6b's path shape, both entry points
    h128_rows, h128_errs, h128_t = timed("flash_dh128", check_flash, torch, kflash, peaks,
                                         QWEN3_FLASH_PATH)
    h128b_rows, h128b_errs, h128b_t = timed("flash_bf16_dh128", check_flash_bf16, torch,
                                            kflash, peaks, QWEN3_FLASH_PATH)
    # head widths 48 and 96, zero-padded to 64 and 128, both entry points
    width_rows, width_errs = timed("flash_widths", check_flash_widths, torch, kflash)
    # the bf16 B1, B2 and B3 (wgmma) at both path shapes: their time beside
    # SDPA's bf16 forward or backward, ptxas's registers and spills, and their
    # error against float64, each beside the old kernels', and the host ns to
    # encode one launch's TMA tensor maps
    def bf16_ptxas(name, dh):
        return None if flash_ptxas is None else {
            flash_entry(k): v for k, v in flash_ptxas.items()
            if f"{name}_bf16_kernelILi{dh}E" in k}

    # the float32 B1 (wgmma, flash_fwd_f32.cu) likewise, beside SDPA's float32
    # forward and the old kernel's time
    f32_fwd = {str(path): {
        "us": 1e3 * t["flash_fwd"]["ms"], "sdpa_fwd_us": 1e3 * t["flash_fwd"]["library_ms"],
        "blocks": t["flash_fwd"]["blocks"], "bound_us": 1e3 * t["flash_fwd"]["bound_ms"],
        "rel_err_f64": t["flash_fwd"]["rel_err_f64"],
        "plain_rel_err_f64": t["flash_fwd"]["plain_rel_err_f64"],
        "ptxas": None if flash_ptxas is None else {
            flash_entry(k): v for k, v in flash_ptxas.items()
            if f"flash_fwd_f32_kernelILi{path[2]}E" in k},
        "old": OLD_F32_FWD[path]}
        for path, t in ((FLASH_PATH, flash_t), (QWEN3_FLASH_PATH, h128_t))}
    # the float32 B2 and B3 (wgmma at head dim 128, flash_bwd_f32.cu; mma.sync
    # at 64, flash_bwd.cu) likewise, beside SDPA's float32 backward and the old
    # kernels' times
    f32_bwd = {}
    for path, t in ((FLASH_PATH, flash_t), (QWEN3_FLASH_PATH, h128_t)):
        f32_bwd[str(path)] = {name: {
            "us": 1e3 * t[name]["ms"], "sdpa_bwd_us": 1e3 * t[name]["library_ms"],
            "blocks": t[name]["blocks"], "bound_us": 1e3 * t[name]["bound_ms"],
            "rel_err_f64": t[name]["rel_err_f64"],
            "plain_rel_err_f64": t[name]["plain_rel_err_f64"],
            # the kernel that serves the width: wgmma at 128, mma.sync below
            "ptxas": None if flash_ptxas is None else {
                flash_entry(k): v for k, v in flash_ptxas.items()
                if f"ILi{path[2]}E" in k and (f"{name}_f32_kernel" in k
                                              or f"{name}_kernel" in k)},
            "old": OLD_F32_BWD[path][name]} for name in ("flash_bwd_dq", "flash_bwd_dkv")}
        f32_bwd[str(path)]["b2_plus_b3_us"] = sum(
            f32_bwd[str(path)][name]["us"] for name in ("flash_bwd_dq", "flash_bwd_dkv"))
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
         "flash_bf16_dh128": h128b_rows, "flash_bf16_dh128_timing_per_launch": h128b_t,
         "flash_widths": width_rows},
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
          "flash_rel_err_f64": {k: {f: t[f] for f in ("rel_err_f64", "plain_rel_err_f64")}
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
          "flash_f32_fwd": f32_fwd, "flash_f32_bwd": f32_bwd, "flash_bf16_fwd": bf16_fwd,
          "flash_bf16_bwd": bf16_bwd,
          "flash_widths": {"cases": len(width_rows), "max_abs_err": width_errs,
                           "padded_to": {r["dh"]: r["padded_to"] for r in width_rows}},
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

    # the tuner: B5's chunks timed on the card into a temporary cache
    torch.cuda.empty_cache()
    emit(tune_phase(torch, kadam, smi))

    # the static analyzer's one-process checks and the quickstart example
    torch.cuda.empty_cache()
    emit(analysis_phase(kernels, smi))
    torch.cuda.empty_cache()
    emit(examples_phase(torch, kernels, smi))

    # phase 3: the sim path
    steps = int(MAIN_ARGS[MAIN_ARGS.index("--steps") + 1])
    want = {k: 0 for k in kernels}
    adam_per_step = -(-len(adam_leaves) // kadam.MAX_LEAVES)  # one grouped launch
    sadam_per_step = -(-len(sadam_leaves) // kadam.MAX_LEAVES)
    want.update(matmul=steps * sum(1 for g in groups if g), adam_scale=steps * adam_per_step)
    with stream_tape("record"):  # phase 4's runs, the resumes and sim_modes replay it
        sim = run_path(train, torch, kernels, MAIN_ARGS, want)
    emit({"phase": "main_path", "data": "sampled", **sim})

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
        with stream_tape("replay"):
            spmd[schedule] = run_path(train, torch, kernels, args, want)
        emit({"phase": f"spmd_{schedule}", "data": "replayed", **spmd[schedule]})

    # phase 4, bf16: the 1F1B path under the bf16_compute policy; B1-B3 through
    # their bf16 entry points only, B4 and B5 on the float32 gradients and state
    torch.cuda.empty_cache()
    bf16_args = SPMD_ARGS + ["--schedule", "1f1b", "--steps", str(BF16_STEPS),
                             "--precision", "bf16"]
    n = BF16_STEPS
    with stream_tape("replay"):
        spmd_bf16 = run_path(train, torch, kernels, bf16_args, {
            **none, "flash_fwd_bf16": n * 2 * M * L, "flash_bwd_dq_bf16": n * M * L,
            "flash_bwd_dkv_bf16": n * M * L, "matmul": n * sum(1 for g in sgroups if g),
            "adam_scale": n * sadam_per_step})
        torch.cuda.empty_cache()
        spmd_bf16["dtype_check"] = check_bf16_dtypes(train, bf16_args)
    emit({"phase": "spmd_bf16", "data": "replayed", **spmd_bf16})

    # phase 4, continued: the resume paths, then the sim staleness modes
    sim_per_step = {k: 0 for k in kernels}
    sim_per_step.update(matmul=sum(1 for g in groups if g), adam_scale=adam_per_step)
    # (their data times and the resumed legs' fast-forwards are copies of
    # main_path's batches: a fast-forward's sampling is main_path's data time
    # a batch times the cut)
    torch.cuda.empty_cache()
    with stream_tape("replay"):
        resume_sim = check_resume(train, torch, kernels, MAIN_ARGS, RESUME_CUT["sim"],
                                  sim_per_step, sim["losses"])
    emit({"phase": "resume_sim", "data": "replayed", **resume_sim})
    torch.cuda.empty_cache()
    fd_args = SPMD_ARGS + ["--schedule", "fill_drain", "--steps", str(SPMD_STEPS["fill_drain"])]
    spmd_per_step = {**none, "flash_fwd": M * L, "flash_bwd_dq": M * L,
                     "flash_bwd_dkv": M * L, "matmul": sum(1 for g in sgroups if g),
                     "adam_scale": sadam_per_step}
    with stream_tape("replay"):
        resume_spmd = check_resume(train, torch, kernels, fd_args, RESUME_CUT["spmd"],
                                   spmd_per_step, spmd["fill_drain"]["losses"])
    emit({"phase": "resume_spmd", "data": "replayed", **resume_spmd})
    modes = {}
    for mode in ("--no-stash", "--weight-prediction"):
        torch.cuda.empty_cache()
        args = list(MAIN_ARGS)
        args[args.index("--steps") + 1] = str(MODE_STEPS)
        with stream_tape("replay"):
            modes[mode] = run_path(train, torch, kernels, args + [mode],
                                   {k: MODE_STEPS * n for k, n in sim_per_step.items()})
    emit({"phase": "sim_modes", "data": "replayed", **modes})

    # the asynchronous data axis on both backends
    torch.cuda.empty_cache()
    data_async, pods_batches = check_data_async(train, torch, kernels, cfg, sim_per_step,
                                                sgroups, sadam_per_step)
    emit({"phase": "data_async", **data_async})

    # the multi-process SPMD path: two ranks through repro_torch.launch.spawn
    torch.cuda.empty_cache()
    spawn_spmd = check_spawn_spmd(train, torch, kernels, cfg, spmd["1f1b"]["losses"],
                                  sgroups, sadam_per_step, pods_batches)
    del pods_batches
    emit({"phase": "spawn_spmd", **spawn_spmd})

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
    # step's time goes (profile_step over one step after a refresh step)
    n = int(XLSTM_ARGS[XLSTM_ARGS.index("--steps") + 1])
    torch.cuda.empty_cache()
    with xlstm_cut():
        xsim = run_path(train, torch, kernels, XLSTM_ARGS, {
            **none, "matmul": n * sum(1 for g in xgroups if g),
            "adam_scale": n * -(-len(xadam_leaves) // kadam.MAX_LEAVES)})
        emit({"phase": "xlstm_sim", "layers": XLSTM_LAYERS, **xsim})
        torch.cuda.empty_cache()
        profile_step.main(XLSTM_ARGS + ["--warmup", "1", "--profile-steps", "1"])
    torch.cuda.empty_cache()
    xserving = check_serve_decode(torch, xcfg, XLSTM_DECODE_TOL)
    emit({"phase": "serve_decode_xlstm", "arch": xcfg.name, "layers": XLSTM_LAYERS, **SERVE,
          **xserving})

    # paper_1b, the abstract's 1B model, at full width on the sim path. The
    # reckoning comes first: the layers are cut (never the widths, and in
    # whole layers per stage) only if the state the step holds and the
    # rotation's transients would take more than 90% of the card, leaving
    # the rest to activations, updates and the allocator
    layers, _, reckon = fit_sim(pcfg, PAPER_1B_ARGS, total)
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
    p1b["gate_gb"] = FIT_SHARE * total / 1e9
    p1b["reckoned_peak_gb"] = reckon["reckoned_peak_bytes"] / 1e9
    p1b["reckoned_gb"] = {k: v / 1e9 for k, v in reckon["bytes"].items()}
    p1b["launches_per_step"] = {k: v / n for k, v in p1b["launches"].items()}
    emit({"phase": "paper_1b_sim", "layers": layers, **p1b})

    # the frontends, the MoE MLP and the Mamba hybrid at full width on the sim path
    frontend_moe = frontend_moe_paths(train, torch, kernels, fits, {
        "llava": (lgroups, ladam_leaves), "musicgen": (mgroups, madam_leaves),
        "jamba": (jgroups, jadam_leaves)}, total)
    # where jamba's step goes: the Mamba scan's share of device time and of
    # host dispatch (its profiler ranges), one step after a refresh step
    torch.cuda.empty_cache()
    with swapped_config("jamba_v0_1_52b", lambda c: c.replace(num_layers=jcfg.num_layers)):
        jprof = profile_step.main(JAMBA_ARGS + ["--batch", str(fits["jamba"][1]), "--warmup",
                                                "1", "--profile-steps", "1"])
    scan = {k: jprof["ranges"].get(k, {}) for k in ("mamba_scan", "mamba_scan_backward")}
    scan_device = sum(r.get("kernel_ms_in_spans", 0.0) for r in scan.values())
    scan_host = sum(r.get("host_ms", 0.0) for r in scan.values())
    emit({"phase": "jamba_profile", "layers": jcfg.num_layers, "wall_ms": jprof["wall_ms"],
          "device_busy_ms": jprof["device_busy_ms"], "groups_ms": jprof["groups_ms"],
          "ranges": jprof["ranges"], "scan_device_ms": scan_device,
          "scan_device_share": scan_device / jprof["device_busy_ms"],
          "scan_host_ms": scan_host, "scan_host_share": scan_host / jprof["wall_ms"]})
    torch.cuda.empty_cache()
    jserving = check_serve_decode(torch, jcfg, JAMBA_DECODE_TOL)
    emit({"phase": "serve_decode_jamba", "arch": jcfg.name, "layers": jcfg.num_layers,
          **SERVE, **jserving})
    # deepseek_v2_236b at full width, one layer: the training step's forward
    # and backward, then decode, from one draw of the weights
    check_deepseek(torch, get_config)

    # the long-sequence paths: qwen3_0_6b trains, prefills and decodes
    # 32,768 tokens; the dry runs (started after the build) are read after
    torch.cuda.empty_cache()
    emit({"phase": "long_context_check", **check_long_context_small(torch)})
    zero_counts(kernels)
    long_ctx = run_long_context(torch, kernels, none, total)  # emits a line for each part
    emit({"phase": "dryrun", **finish_dryruns(dryruns)})

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
    data_async_cuda_vs_cpu(train)
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
    # the 32-token sequences, xlstm_1_3b (an mLSTM and an sLSTM block), llava
    # (a 4-token prefix), musicgen (four codebooks and a prefix) and mixtral
    # (B4 on its batched expert stacks) on the sim path, and mixtral on 1F1B
    # with a window of 16 (B1-B3 windowed, B4 over the stacked layers and
    # experts); jamba (a Mamba block and an attention block) on the sim path,
    # deepseek (MLA, which no kernel serves, and a shared expert) on the sim
    # and 1F1B paths
    for arch, backend, change in (
            ("qwen3_0_6b", ["--backend", "spmd", "--schedule", "1f1b"], {"head_dim": 128}),
            ("qwen1_5_0_5b", ["--backend", "sim"], {}),
            ("phi4_mini_3_8b_swa", ["--backend", "spmd", "--schedule", "1f1b"],
             {"window": 16}),
            ("xlstm_1_3b", ["--backend", "sim"], {}),
            ("llava_next_34b", ["--backend", "sim"], {}),
            ("musicgen_large", ["--backend", "sim"], {}),
            ("mixtral_8x22b", ["--backend", "sim"], {}),
            ("mixtral_8x22b", ["--backend", "spmd", "--schedule", "1f1b"], {"window": 16}),
            ("jamba_v0_1_52b", ["--backend", "sim"], {}),
            ("deepseek_v2_236b", ["--backend", "sim"], {}),
            ("deepseek_v2_236b", ["--backend", "spmd", "--schedule", "1f1b"], {})):
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
    # musicgen's codebook decode at smoke size in float32: the teacher-forced
    # prompt logits card against CPU within float32 roundoff, every codebook
    # generated a step
    from repro_torch.launch.serve_decode import serve

    mcfg = get_config("musicgen_large", smoke=True).replace(dtype="float32")
    on = {dev: serve(mcfg, 2, 4, 6, torch.device(dev)) for dev in ("cuda", "cpu")}
    err = float((on["cuda"]["prompt_logits"].cpu() - on["cpu"]["prompt_logits"]).abs().max())
    shapes = {dev: list(r["generated"].shape) for dev, r in on.items()}
    emit({"phase": "cuda_vs_cpu", "decode": mcfg.name, "prompt_logits_max_abs_err": err,
          "generated_shape": shapes["cuda"], "tokens_equal": bool(torch.equal(
              on["cuda"]["generated"].cpu(), on["cpu"]["generated"]))})
    if err > 1e-4 or any(v != [2, 6, mcfg.num_codebooks] for v in shapes.values()):
        raise AssertionError(f"musicgen decode: card vs CPU {err}, shapes {shapes}")
    del on
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
               for path in ("sim", "spmd", "xlstm_sim", "paper_1b_sim", "llava_sim",
                            "musicgen_sim", "jamba_sim", "long_context")}
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
    # B4 and B5 per step of the frontend and jamba paths, at the groups phase 2 timed
    for key, path, arch, (pgrp, pleaves) in (
            ("llava", "llava_sim", "llava_next_34b", (lgroups, ladam_leaves)),
            ("musicgen", "musicgen_sim", "musicgen_large", (mgroups, madam_leaves)),
            ("jamba", "jamba_sim", "jamba_v0_1_52b", (jgroups, jadam_leaves))):
        run = frontend_moe[key]
        bound_ms, _, bound_by = bounds(*mm_work([p for g in pgrp for p in g]), peaks,
                                       TF32_PASSES)
        rows.append({
            "name": f"matmul_{arch}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/matmul.cu",
            "replaces": "src/repro/kernels/matmul.py:30",
            "launches": run["launches"]["matmul"],
            "max_abs_err": max(r["max_abs_err"] for r in grp_rows
                               if r["group"].startswith(path + "/")),
            "ms": grouped[path]["ms"], "plain_ms": grouped[path]["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": grouped[path]["library_ms"], "layers": run["layers"]})
        rows.append({
            "name": f"adam_scale_{arch}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/adam_step.cu",
            "replaces": "src/repro/kernels/adam_step.py:28",
            "launches": run["launches"]["adam_scale"],
            "max_abs_err": max(b5_step[path]["max_abs_err"],
                               b5_step[path]["inplace_max_abs_err"]),
            "ms": b5_step[path]["ms"], "per_leaf_ms": b5_step[path]["per_leaf_ms"],
            "plain_ms": b5_step[path]["plain_ms"], "bound_ms": adam_bound(pleaves)[0],
            "bound_by": adam_bound(pleaves)[1], "library_ms": None, "layers": run["layers"]})
    # B4 and B5 per step of the long-context train step (qwen3_0_6b stacked,
    # 32,768 tokens), at the groups phase 2 timed
    lc_steps = long_ctx["train"]["launches_per_step"]
    lc_bound_ms, _, lc_bound_by = bounds(*mm_work([p for g in lcgroups for p in g]), peaks,
                                         TF32_PASSES)
    rows.append({
        "name": "matmul_long_context", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:30",
        "launches": sum(c["matmul"] for c in lc_steps),
        "max_abs_err": max(r["max_abs_err"] for r in grp_rows
                           if r["group"].startswith("long_context/")),
        "ms": grouped["long_context"]["ms"], "plain_ms": grouped["long_context"]["plain_ms"],
        "bound_ms": lc_bound_ms, "bound_by": lc_bound_by,
        "library_ms": grouped["long_context"]["library_ms"], "layers": long_ctx["layers"]})
    rows.append({
        "name": "adam_scale_long_context", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adam_step.cu",
        "replaces": "src/repro/kernels/adam_step.py:28",
        "launches": sum(c["adam_scale"] for c in lc_steps),
        "max_abs_err": max(b5_step["long_context"]["max_abs_err"],
                           b5_step["long_context"]["inplace_max_abs_err"]),
        "ms": b5_step["long_context"]["ms"], "per_leaf_ms": b5_step["long_context"]["per_leaf_ms"],
        "plain_ms": b5_step["long_context"]["plain_ms"],
        "bound_ms": adam_bound(lcadam_leaves)[0], "bound_by": adam_bound(lcadam_leaves)[1],
        "library_ms": None, "layers": long_ctx["layers"]})
    onef = spmd["1f1b"]
    # computed, so kept off the kernels line
    bound_fp32 = {"matmul": mm_bound_f32, "matmul_xlstm": xmm_bound_f32,
                  "matmul_paper_1b": pmm_bound_f32}
    for kname, src, replaces in (
        ("flash_fwd", "src/repro_torch/kernels/csrc/flash_fwd_f32.cu",
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
        ("flash_fwd", "src/repro_torch/kernels/csrc/flash_fwd_f32.cu",
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
            ("flash_fwd", "src/repro_torch/kernels/csrc/flash_fwd_f32.cu",
             "src/repro/kernels/flash.py:80"),
            ("flash_bwd_dq", "src/repro_torch/kernels/csrc/flash_bwd_f32.cu",
             "src/repro/kernels/flash.py:162"),
            ("flash_bwd_dkv", "src/repro_torch/kernels/csrc/flash_bwd_f32.cu",
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
         "The matmul_<arch> and adam_scale_<arch> rows are B4 and B5 per step of the "
         "llava_next_34b, musicgen_large and jamba_v0_1_52b sim paths, cut to their layers "
         "(phases llava_sim, musicgen_sim, jamba_sim: launches of their 4-step runs); "
         "library_ms is torch.matmul on contiguous operands of each of the step's products. "
         "The *_long_context rows are B4 and B5 per step of qwen3_0_6b's stacked train "
         "step at 32,768 tokens (long_context_train: its launches), timed at its groups. "
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
         "data_async_launches": {**{f"sim_{k}": r["launches"]
                                    for k, r in data_async["sim"].items()},
                                 "spmd_1f1b": data_async["spmd_1f1b"]["launches"]},
         "xlstm_sim_launches": xsim["launches"],
         "paper_1b_sim_launches": p1b["launches"],
         **{f"{k}_sim_launches": r["launches"] for k, r in frontend_moe.items()},
         "baselines_launches": {path: {n: r["launches"] for n, r in runs.items()}
                                for path, runs in baselines.items()},
         "long_context_launches": long_ctx["train"]["launches_per_step"]}, indent=1))
    emit({"bound_fp32_ms": bound_fp32})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
