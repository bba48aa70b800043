#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc``.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the main paths give it, plus ragged, batched and masked shapes,
   and times kernel, plain version and library call with CUDA events. B4
   runs per shape as a group of one and as the grouped launches of both
   paths (each path's four groups, a mixed ragged group for every pair of
   transpose flags, a group of one); B1, B2 and B3 must each repeat
   bitwise.
3. Drives the sim path through ``repro_torch.launch.train.main``: the
   full-width paper_95m model, 8-stage simulated staleness, basis-rotation
   Adam with ``--use-kernels``, for 12 steps. Checks that the losses are
   finite and that every rotation product and rotated Adam step went through
   the kernels, by their launch counts (four grouped B4 launches per step).
4. Holds both SPMD schedules' gradients at full width, through B1-B3, to
   the whole-model gradient on one batch. Then drives the SPMD path like
   the sim path: full-width paper_95m on 8 stacked stages with 8
   microbatches, basis rotation and ``--use-kernels``, under the 1F1B
   schedule for 12 steps and the fill-drain schedule for 4 (the cosine
   schedule's length is the step count, so the two curves differ after the
   first steps). Checks finite losses and the exact launch counts of all
   five kernels.
5. Runs the reduced model for a few steps on the card and on the CPU (plain
   kernel versions) from the same seed, on both backends (and both SPMD
   schedules), with Adam and with basis rotation through the kernels, and
   compares the losses.

Each phase prints one JSON line; then the kernel table, the card's line
from ``nvidia-smi``, and last ``{"ok": true, "device": {...}}``. Any failure
raises and the exit code is not 0. Without CUDA, or without the repository's
``src/`` beside it, it exits non-zero before printing any result. Details
(the compiler's register report, the per-shape timings) go to
``chiprun_out/``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

MAIN_ARGS = ["--arch", "paper_95m", "--backend", "sim", "--stages", "8",
             "--optimizer", "basis_rotation", "--use-kernels", "--steps", "12",
             "--batch", "8", "--seq", "256", "--log-every", "1"]
SMOKE_ARGS = ["--smoke", "--stages", "2", "--steps", "6", "--batch", "4",
              "--seq", "32", "--log-every", "0"]
SPMD_ARGS = ["--arch", "paper_95m", "--backend", "spmd", "--stages", "8",
             "--microbatches", "8", "--optimizer", "basis_rotation", "--use-kernels",
             "--batch", "8", "--seq", "256", "--log-every", "1"]
SPMD_STEPS = {"1f1b": 12, "fill_drain": 4}

# Published dense peaks (NVIDIA data sheets): float32 outside the tensor
# cores, device memory bandwidth, and TF32 on the tensor cores. The SXM part
# is the default.
PEAKS = {
    "PCIe": (51.2e12, 2.0e12, 378e12),
    "NVL": (60.0e12, 3.9e12, 417.5e12),
    "SXM": (67.0e12, 3.35e12, 495e12),
}
TF32_PASSES = 3  # the 3xTF32 split: three tensor-core products per float32 product

SLEEP_CYCLES = 50_000_000  # ~25 ms at 2 GHz: longer than the host takes to enqueue a timing run
MATMUL_RTOL, MATMUL_ATOL = 2e-3, 1e-4  # tests/test_kernels.py rotation parity
ADAM_RTOL, ADAM_ATOL = 1e-5, 1e-6  # tests/test_kernels.py fused Adam parity
FWD_RTOL, FWD_ATOL = 2e-3, 2e-4  # tests/test_kernels.py:87 flash forward parity
BWD_RTOL, BWD_ATOL = 2e-3, 1e-4  # tests/test_kernels.py:137-142 flash backward parity
FLASH_PATH = (6, 256, 64)  # (heads, S, dh) of one attention call on the paper_95m path
# B2 and B3 at the path shape: relative error against a float64 backward at most this
# many times the plain version's. One TF32 pass instead of three is ~1e3 times off.
F64_ERR_FACTOR = 4


def emit(obj) -> None:
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


def path_groups(cfg, stages: int = 0):
    """One step of a path's rotation products as the optimizer issues them:
    four grouped B4 launches (U^T [G, M], [G, M] V, U S, S V^T over every
    rotated leaf in leaf order), each a list of problems
    (batch, M, K, N, trans_a, trans_b), and {leaf shape: count} of B5
    launches. With ``stages``, the SPMD path's stacked layout: one problem
    per rotated leaf kind, batched over all its layers."""
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
    return groups, Counter(p.shape for p in plans)


def product_counts(groups):
    """{(batch, M, K, N, trans_a, trans_b): count} over a step's groups."""
    return Counter(key for group in groups for key in group)


def mm_work(problems):
    """(flops, bytes) of a list of products: each input read once, each
    output written once."""
    flops = sum(2.0 * b * M * K * N for b, M, K, N, _, _ in problems)
    nbytes = sum(4.0 * b * (M * K + K * N + M * N) for b, M, K, N, _, _ in problems)
    return flops, nbytes


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
    pair per launch, and its plain version. Returns (rows, max_abs_err)."""
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
            row["ms"], row["host_ms"] = time_ms(
                lambda: kmm.matmul_grouped(As, Bs, trans_a=ta, trans_b=tb), reps=10, warmup=2)
            row["plain_ms"], _ = time_ms(
                lambda: kmm.matmul_grouped_plain(As, Bs, trans_a=ta, trans_b=tb),
                reps=10, warmup=2)
            flops, nbytes = mm_work(problems)
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


def check_adam(torch, kadam, peaks):
    """B5 at the path shapes, a ragged shape and a first-step (v = 0) case."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    beta2, eps, bc1, bc2 = 0.999, 1e-8, 1 - 0.9 ** 4, 1 - 0.999 ** 4
    rows, worst = [], 0.0
    cases = [((384, 384), True, False), ((384, 1536), True, False),
             ((1536, 384), True, False), ((97, 33), False, False), ((384, 384), False, True),
             ((8, 4, 384, 384), True, False), ((8, 4, 384, 1536), True, False),
             ((8, 4, 1536, 384), True, False)]
    for shape, timed, zero_v in cases:
        g = torch.randn(shape, device="cuda", generator=gen) * 1e-3
        m = torch.randn(shape, device="cuda", generator=gen) * 1e-3
        v = torch.zeros(shape, device="cuda") if zero_v else (
            torch.randn(shape, device="cuda", generator=gen).abs() * 1e-6 + 1e-8)
        step, v_new = kadam.adam_scale(g, m, v, beta2, eps, bc1, bc2)
        s_want, v_want = kadam.adam_scale_plain(g, m, v, beta2, eps, bc1, bc2)
        torch.cuda.synchronize()
        err = max((step - s_want).abs().max().item(), (v_new - v_want).abs().max().item())
        rel = max(((step - s_want).abs() / s_want.abs().clamp(min=ADAM_ATOL)).max().item(),
                  ((v_new - v_want).abs() / v_want.abs().clamp(min=ADAM_ATOL)).max().item())
        worst = max(worst, err)
        if not (torch.allclose(step, s_want, rtol=ADAM_RTOL, atol=ADAM_ATOL)
                and torch.allclose(v_new, v_want, rtol=ADAM_RTOL, atol=ADAM_ATOL)):
            raise AssertionError(f"adam_scale {shape} (v=0: {zero_v}): max abs err {err}")
        row = {"shape": list(shape), "zero_v": zero_v, "max_abs_err": err, "max_rel_err": rel,
               "bitwise_equal": bool(torch.equal(step, s_want) and torch.equal(v_new, v_want))}
        if timed:
            row["ms"], row["host_ms"] = time_ms(
                lambda: kadam.adam_scale(g, m, v, beta2, eps, bc1, bc2))
            row["plain_ms"], _ = time_ms(
                lambda: kadam.adam_scale_plain(g, m, v, beta2, eps, bc1, bc2))
            row["bound_ms"] = 1e3 * 20.0 * g.numel() / peaks[1]
        rows.append(row)
    return rows, worst


def flash_work(BH: int, S: int, dh: int, window=None):
    """Operations and bytes the three flash kernels need at one shape:
    products over the visible (causal, windowed) entries only, each input
    read once and each output written once. Returns {kernel: (flops, bytes)}."""
    nnz = sum(min(i + 1, window or i + 1) for i in range(S))
    head, row = 4.0 * BH * S * dh, 4.0 * BH * S  # float32 bytes of a (S, dh) and a (S,) per head
    return {"flash_fwd": (4.0 * dh * nnz * BH, 3 * head + head + row),       # QK, PV; O and L
            "flash_bwd_dq": (6.0 * dh * nnz * BH, 4 * head + 2 * row + head),  # QK, dO V, dS K
            "flash_bwd_dkv": (8.0 * dh * nnz * BH, 4 * head + 2 * row + 2 * head)}


def check_flash(torch, kflash, peaks):
    """B1-B3 against their plain versions: the path shape, the reference's
    sweeps (windows None, 100, 32; S 256, 128, 200, 100) and a fully-masked
    row case; each kernel run twice on every case must repeat bitwise. Times
    all three, their plain versions and PyTorch's SDPA forward and backward
    at the path shape. Returns (rows, errs, timing)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, errs = [], {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    cases = [(FLASH_PATH, None, None)]
    cases += [((6, S, 64), w, None) for S in (256, 128) for w in (None, 100, 32)]
    cases += [((2, S, 32), w, None) for S in (200, 100) for w in (None, 100, 32, 16)]
    cases += [((1, 128, 16), 8, 100)]  # keys past 100 masked: rows >= 107 see none
    for (BH, S, dh), window, seq_len in cases:
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
    BH, S, dh = FLASH_PATH
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
    for name, (flops, nbytes) in flash_work(BH, S, dh).items():  # all three in 3xTF32
        tc, f32, by = bounds(flops, nbytes, peaks, TF32_PASSES)
        timing[name].update(bound_ms=tc, bound_fp32_ms=f32, bound_by=by)
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
    for fn in kernels.values():
        fn.launches = 0


def read_counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def run_path(train, torch, kernels, args, want):
    """Drive one path through the launcher with every launch count zeroed
    just before and read just after; check finite losses and the counts."""
    steps = int(args[args.index("--steps") + 1])
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    t0 = time.perf_counter()
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
            "step_s": step_s, "data_s": data_s,
            "median_step_s": statistics.median(step_s),
            "median_step_s_no_refresh": statistics.median(plain_steps),
            "refresh_step_s": [step_s[t] for t in refresh],
            "median_data_s": statistics.median(data_s),
            "tokens_per_s_step": tokens / statistics.median(step_s),
            "tokens_per_s_wall": tokens * steps / wall,
            "wall_s": wall, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


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
    from repro_torch.launch import train

    kernels = {"flash_fwd": kflash.flash_fwd, "flash_bwd_dq": kflash.flash_bwd_dq,
               "flash_bwd_dkv": kflash.flash_bwd_dkv, "matmul": kmm.matmul,
               "adam_scale": kadam.adam_scale}
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
    emit({"phase": "device", "nvidia_smi": smi, "kind": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks_for": part,
          "f32_peak_tflops": peaks[0] / 1e12, "mem_tb_s": peaks[1] / 1e12,
          "tf32_peak_tflops": peaks[2] / 1e12,
          "build_s": lib.build_seconds, "library": lib.path.name})

    # phase 2: each kernel against its plain version. B4 per shape as a
    # group of one, then as the grouped launches of the sim and SPMD paths
    # (K stages of L / K layers each)
    cfg = get_config("paper_95m")
    K, M, L = 8, 8, cfg.num_layers
    (groups, adam_counts), (sgroups, sadam_counts) = path_groups(cfg), path_groups(cfg, K)
    mm_counts, smm_counts = product_counts(groups), product_counts(sgroups)
    mm_rows, mm_err = check_matmul(torch, kmm, peaks)
    grp_rows, grp_err = check_matmul_groups(torch, kmm, {"sim": groups, "spmd": sgroups}, peaks)
    mm_err = max(mm_err, grp_err)
    adam_rows, adam_err = check_adam(torch, kadam, peaks)
    flash_rows, flash_errs, flash_t = check_flash(torch, kflash, peaks)
    (OUT_DIR / "chip_smoke_kernels.json").write_text(json.dumps(
        {"matmul": mm_rows, "matmul_grouped": grp_rows, "adam_scale": adam_rows,
         "flash": flash_rows, "flash_timing_per_launch": flash_t}, indent=1))
    emit({"phase": "kernels", "matmul_cases": len(mm_rows) + len(grp_rows),
          "matmul_max_abs_err": mm_err,
          "matmul_grouped_ms": {r["group"]: r["ms"] for r in grp_rows if "ms" in r},
          "adam_cases": len(adam_rows), "adam_max_abs_err": adam_err,
          "adam_max_rel_err": max(r["max_rel_err"] for r in adam_rows),
          "adam_bitwise_equal": all(r["bitwise_equal"] for r in adam_rows),
          "flash_cases": len(flash_rows), "flash_max_abs_err": flash_errs,
          "flash_ms_per_launch": {k: {f: t[f] for f in ("ms", "plain_ms", "library_ms",
                                                        "bound_ms", "host_ms")}
                                  for k, t in flash_t.items()},
          "flash_blocks": {k: t["blocks"] for k, t in flash_t.items()},
          "flash_bwd_rel_err_f64": {k: {f: t[f] for f in ("rel_err_f64", "plain_rel_err_f64")}
                                    for k, t in flash_t.items() if "rel_err_f64" in t},
          "flash_bitwise_repeat": {k: all(r[k + "_bitwise_repeat"] for r in flash_rows)
                                   for k in flash_t}})

    # phase 3: the sim path
    steps = int(MAIN_ARGS[MAIN_ARGS.index("--steps") + 1])
    want = {k: 0 for k in kernels}
    want.update(matmul=steps * sum(1 for g in groups if g),
                adam_scale=steps * sum(adam_counts.values()))
    sim = run_path(train, torch, kernels, MAIN_ARGS, want)
    emit({"phase": "main_path", **sim})

    # phase 4: the SPMD path, both schedules; M microbatches over L layers
    emit(check_schedule_grads(torch, cfg, K, M))
    torch.cuda.empty_cache()
    spmd = {}
    for schedule, n in SPMD_STEPS.items():
        args = SPMD_ARGS + ["--schedule", schedule, "--steps", str(n)]
        fwd = 2 if schedule == "1f1b" else 1  # 1F1B recomputes in its backward
        want = {"flash_fwd": n * fwd * M * L, "flash_bwd_dq": n * M * L,
                "flash_bwd_dkv": n * M * L, "matmul": n * sum(1 for g in sgroups if g),
                "adam_scale": n * sum(sadam_counts.values())}
        spmd[schedule] = run_path(train, torch, kernels, args, want)
        emit({"phase": f"spmd_{schedule}", **spmd[schedule]})

    # phase 5: the reduced model on the card against the CPU, same seed.
    # Adam has no QR: the devices differ only in float32 summation order
    # (measured ~1e-6 apart). Basis rotation: the refresh's QR of
    # rank-deficient grams fixes the basis past the rank by roundoff alone,
    # so the runs are held to the reference's own tolerance for two
    # implementations of this step (tests/test_engine.py:437-438).
    for backend in (["--backend", "sim"], ["--backend", "spmd", "--schedule", "1f1b"],
                    ["--backend", "spmd", "--schedule", "fill_drain"]):
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

    # the kernel table. B4 and B5: per training step of the sim path (B4: its
    # four grouped launches; the plain and library times summed per product
    # over the step's products); B1-B3: per training step of the SPMD 1F1B
    # path (launches per step times the per-launch time at the path shape).
    # Bounds: B4 and B1-B3 on the tensor route (3xTF32), with the float32
    # FMA route beside them; B5 as it runs, on the FMA pipes.
    shape_key = lambda r: (*r["shape"], r["trans_a"], r["trans_b"])  # noqa: E731
    mm_tot = per_step(mm_rows, mm_counts, shape_key)
    smm_tot = per_step(mm_rows, smm_counts, shape_key)
    grouped = {path: {f: sum(r[f] for r in grp_rows if r["group"].startswith(path + "/"))
                      for f in ("ms", "plain_ms")} for path in ("sim", "spmd")}
    adam_tot = per_step(adam_rows, adam_counts, lambda r: tuple(r["shape"]))
    mm_bound, mm_bound_f32, mm_by = bounds(*mm_work([p for g in groups for p in g]), peaks,
                                           TF32_PASSES)
    adam_bytes = sum(20.0 * math.prod(sh) * c for sh, c in adam_counts.items())
    adam_flops = sum(10.0 * math.prod(sh) * c for sh, c in adam_counts.items())
    _, adam_bound, _ = bounds(adam_flops, adam_bytes, peaks)
    rows = [{
        "name": "matmul", "route": "cuda", "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:30", "launches": sim["launches"]["matmul"],
        "max_abs_err": mm_err, "ms": grouped["sim"]["ms"], "plain_ms": grouped["sim"]["plain_ms"],
        "bound_ms": mm_bound, "bound_by": mm_by, "library_ms": mm_tot["library_ms"],
        "spmd_ms": grouped["spmd"]["ms"],
        "spmd_plain_ms": grouped["spmd"]["plain_ms"], "spmd_library_ms": smm_tot["library_ms"],
        "spmd_launches_1f1b": spmd["1f1b"]["launches"]["matmul"],
    }, {
        "name": "adam_scale", "route": "cuda", "source": "src/repro_torch/kernels/csrc/adam_step.cu",
        "replaces": "src/repro/kernels/adam_step.py:28", "launches": sim["launches"]["adam_scale"],
        "max_abs_err": adam_err, "ms": adam_tot["ms"], "plain_ms": adam_tot["plain_ms"],
        "bound_ms": adam_bound,
        "bound_by": "operations" if adam_flops / peaks[0] >= adam_bytes / peaks[1] else "bytes",
        "library_ms": None,
    }]
    onef = spmd["1f1b"]
    bound_fp32 = {"matmul": mm_bound_f32}  # computed, so kept off the kernels line
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
    (OUT_DIR / "chip_smoke_summary.json").write_text(json.dumps(
        {"nvidia_smi": smi, "kernels": rows, "note": "ms, plain_ms, bound_ms and library_ms "
         "are per training step: B4 and B5 of the sim path, B1-B3 of the SPMD 1F1B path; "
         "launches are the counts of those runs. B4's spmd_* keys are per SPMD step. "
         "bound_ms of B4 and B1-B3 is the tensor route (3xTF32 at the TF32 rate, or bytes), "
         "bound_fp32_ms the float32 FMA route, per training step likewise. blocks_per_launch "
         "is the grid that B1-B3's launches recorded at the path shape. The library time of B2 and of B3 is the "
         "time of SDPA's whole backward (dQ, dK and dV in one call)",
         "bound_fp32_ms": bound_fp32,
         "spmd_fill_drain_launches": spmd["fill_drain"]["launches"]}, indent=1))
    emit({"bound_fp32_ms": bound_fp32})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
