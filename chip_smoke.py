#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc``.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, plus ragged and batched shapes, and times
   kernel, plain version and library call with CUDA events.
3. Drives the main path through ``repro_torch.launch.train.main``: the
   full-width paper_95m model, 8-stage simulated staleness, basis-rotation
   Adam with ``--use-kernels``, for 12 steps. Checks that the losses are
   finite and that every rotation product and rotated Adam step went through
   the kernels, by their launch counts.
4. Runs the reduced model for a few steps on the card and on the CPU (plain
   kernel versions) from the same seed, with Adam and with basis rotation
   through the kernels, and compares the losses.

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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

MAIN_ARGS = ["--arch", "paper_95m", "--backend", "sim", "--stages", "8",
             "--optimizer", "basis_rotation", "--use-kernels", "--steps", "12",
             "--batch", "8", "--seq", "256", "--log-every", "1"]
SMOKE_ARGS = ["--smoke", "--stages", "2", "--steps", "6", "--batch", "4",
              "--seq", "32", "--log-every", "0"]

# Published dense peaks (NVIDIA data sheets): float32 outside the tensor
# cores, and device memory bandwidth. The SXM part is the default.
PEAKS = {
    "PCIe": (51.2e12, 2.0e12),
    "NVL": (60.0e12, 3.9e12),
    "SXM": (67.0e12, 3.35e12),
}

SLEEP_CYCLES = 50_000_000  # ~25 ms at 2 GHz: longer than the host takes to enqueue a timing run
MATMUL_RTOL, MATMUL_ATOL = 2e-3, 1e-4  # tests/test_kernels.py rotation parity
ADAM_RTOL, ADAM_ATOL = 1e-5, 1e-6  # tests/test_kernels.py fused Adam parity


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


def path_products(cfg):
    """Per-step launch multisets of the main path, from the model's rotation
    layout: {(M, K, N, trans_a, trans_b): count} and {(R, C): count}."""
    from repro_torch.core.layout import build_layout
    from repro_torch.models import Transformer, param_leaves

    meta = Transformer(cfg.replace(scan_layers=False), device="meta", seed=None)
    mm, adam = {}, {}
    for plan in build_layout(param_leaves(meta), "bilateral"):
        if not plan.rotate:
            continue
        m, n = plan.shape
        # U^T X V for g and m, then U S V^T: two products each
        for key, c in (((m, m, n, True, False), 2), ((m, n, n, False, False), 2),
                       ((m, m, n, False, False), 1), ((m, n, n, False, True), 1)):
            mm[key] = mm.get(key, 0) + c
        adam[(m, n)] = adam.get((m, n), 0) + 1
    return mm, adam


def check_matmul(torch, kmm, peaks):
    """B4 at the path shapes (every transpose flag the path uses), plus
    ragged and batched shapes. Returns (rows, max_abs_err)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], 0.0
    shapes = [(1, 384, 384, 384), (1, 384, 384, 1536), (1, 384, 1536, 1536),
              (1, 1536, 1536, 384), (1, 1536, 384, 384)]
    flags = [(True, False), (False, False), (False, True)]
    cases = [(s, f, True) for s in shapes for f in flags]
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
            flops, nbytes = 2.0 * M * N * K, 4.0 * (M * K + K * N + M * N)
            row["bound_ms"] = 1e3 * max(flops / peaks[0], nbytes / peaks[1])
            row["tflops"] = flops / row["ms"] / 1e9
        rows.append(row)
    return rows, worst


def check_adam(torch, kadam, peaks):
    """B5 at the path shapes, a ragged shape and a first-step (v = 0) case."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    beta2, eps, bc1, bc2 = 0.999, 1e-8, 1 - 0.9 ** 4, 1 - 0.999 ** 4
    rows, worst = [], 0.0
    cases = [((384, 384), True, False), ((384, 1536), True, False),
             ((1536, 384), True, False), ((97, 33), False, False), ((384, 384), False, True)]
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
    from repro_torch.kernels import matmul as kmm
    from repro_torch.launch import train

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
          "build_s": lib.build_seconds, "library": lib.path.name})

    # phase 2: each kernel against its plain version
    mm_rows, mm_err = check_matmul(torch, kmm, peaks)
    adam_rows, adam_err = check_adam(torch, kadam, peaks)
    (OUT_DIR / "chip_smoke_kernels.json").write_text(
        json.dumps({"matmul": mm_rows, "adam_scale": adam_rows}, indent=1))
    emit({"phase": "kernels", "matmul_cases": len(mm_rows), "matmul_max_abs_err": mm_err,
          "adam_cases": len(adam_rows), "adam_max_abs_err": adam_err,
          "adam_max_rel_err": max(r["max_rel_err"] for r in adam_rows),
          "adam_bitwise_equal": all(r["bitwise_equal"] for r in adam_rows)})

    # phase 3: the main path, counts zeroed just before and read just after
    cfg = get_config("paper_95m")
    mm_counts, adam_counts = path_products(cfg)
    steps = int(MAIN_ARGS[MAIN_ARGS.index("--steps") + 1])
    torch.cuda.reset_peak_memory_stats()
    kmm.matmul.launches = 0
    kadam.adam_scale.launches = 0
    t0 = time.perf_counter()
    result = train.main(MAIN_ARGS)
    wall = time.perf_counter() - t0
    launches = {"matmul": kmm.matmul.launches, "adam_scale": kadam.adam_scale.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = result["losses"]
    want = {"matmul": steps * sum(mm_counts.values()),
            "adam_scale": steps * sum(adam_counts.values())}
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"main path losses: {losses}")
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    step_s, data_s = result["step_s"], result["data_s"]
    tokens = result["tokens_per_step"]
    refresh = [t for t in range(steps) if t % 10 == 0]
    plain_steps = [s for t, s in enumerate(step_s) if t not in refresh]
    emit({"phase": "main_path", "args": " ".join(MAIN_ARGS), "losses": losses,
          "launches": launches, "step_s": step_s, "data_s": data_s,
          "median_step_s": statistics.median(step_s),
          "median_step_s_no_refresh": statistics.median(plain_steps),
          "refresh_step_s": [step_s[t] for t in refresh],
          "median_data_s": statistics.median(data_s),
          "tokens_per_s_step": tokens / statistics.median(step_s),
          "tokens_per_s_wall": tokens * steps / wall,
          "wall_s": wall, "peak_mem_gb": peak_gb})

    # phase 4: the reduced model on the card against the CPU, same seed.
    # Adam has no QR: the devices differ only in float32 summation order
    # (measured ~1e-6 apart). Basis rotation: the refresh's QR of
    # rank-deficient grams fixes the basis past the rank by roundoff alone,
    # so the runs are held to the reference's own tolerance for two
    # implementations of this step (tests/test_engine.py:437-438).
    for opt, first2_tol, all_tol in ((["--optimizer", "adam"], 1e-4, 1e-4),
                                     (["--use-kernels"], 2e-3, 5e-2)):
        gpu = train.main(SMOKE_ARGS + opt)["losses"]
        cpu = train.main(SMOKE_ARGS + opt + ["--device", "cpu"])["losses"]
        diffs = [abs(a - b) for a, b in zip(gpu, cpu)]
        if not (len(diffs) == len(cpu) and max(diffs[:2]) < first2_tol
                and max(diffs) < all_tol):
            raise AssertionError(f"{opt}: cuda vs cpu losses differ: {gpu} vs {cpu}")
        emit({"phase": "cuda_vs_cpu", "args": " ".join(SMOKE_ARGS + opt), "cuda": gpu,
              "cpu": cpu, "max_diff_first2": max(diffs[:2]), "max_diff": max(diffs)})

    # the kernel table: per-step totals over the main path's launch multiset
    mm_tot = per_step(mm_rows, mm_counts,
                      lambda r: (r["shape"][1], r["shape"][2], r["shape"][3],
                                 r["trans_a"], r["trans_b"]))
    adam_tot = per_step(adam_rows, adam_counts, lambda r: tuple(r["shape"]))
    mm_flops = sum(2.0 * M * K * N * c for (M, K, N, _, _), c in mm_counts.items())
    mm_bytes = sum(4.0 * (M * K + K * N + M * N) * c for (M, K, N, _, _), c in mm_counts.items())
    adam_bytes = sum(20.0 * R * C * c for (R, C), c in adam_counts.items())
    adam_flops = sum(10.0 * R * C * c for (R, C), c in adam_counts.items())
    kernels = []
    for kname, src, replaces, tot, flops, nbytes, err, lib_ms in (
        ("matmul", "src/repro_torch/kernels/csrc/matmul.cu",
         "src/repro/kernels/matmul.py:30", mm_tot, mm_flops, mm_bytes, mm_err,
         mm_tot["library_ms"]),
        ("adam_scale", "src/repro_torch/kernels/csrc/adam_step.cu",
         "src/repro/kernels/adam_step.py:28", adam_tot, adam_flops, adam_bytes, adam_err,
         None),
    ):
        t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": err,
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
        })
    (OUT_DIR / "chip_smoke_summary.json").write_text(json.dumps(
        {"nvidia_smi": smi, "kernels": kernels, "note": "ms, plain_ms, bound_ms and "
         "library_ms are per training step of the main path"}, indent=1))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
