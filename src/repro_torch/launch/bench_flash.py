"""B1, B2 and B3, the flash kernels, on the card: the bf16 entry points' and
the float32 ones' correctness at the edges of their 64-row tiles, and their
time at the path shapes beside SDPA's.

    PYTHONPATH=src python -m repro_torch.launch.bench_flash
    PYTHONPATH=src python -m repro_torch.launch.bench_flash --check
    PYTHONPATH=src python -m repro_torch.launch.bench_flash --save out.pt
    python -m repro_torch.launch.bench_flash --compare a.pt b.pt
    cd OTHER_TREE && PYTHONPATH=src python /path/to/bench_flash.py

Timing (the default): first a line with the card and ptxas's registers and
spills for every flash kernel the library built; then at paper_95m's path
shape (6, 256, 64) and qwen3_0_6b's (16, 256, 128), causal, one JSON line
each: in bf16 the device ms per launch of ``flash_fwd`` (B1),
``flash_bwd_dq`` (B2), ``flash_bwd_dkv`` (B3), of SDPA's bf16 forward and
of its whole bf16 backward; in float32 (``float32``) the same of B1, B2 and
B3 beside SDPA's float32 forward and backward (each the median of 30
back-to-back calls between CUDA events, behind a sleep kernel); the grid
each launch recorded, each kernel's relative Frobenius error against a
float64 forward or backward beside its plain version's, the time of a
launch that zeroes 16 floats (what any launch costs timed this way) and,
where the library has them, the host ns to encode one launch's TMA tensor
maps (three for B1, four for B2 and B3). Run from another tree's root with
that tree's ``src`` on ``PYTHONPATH``, it times that tree's kernels: an A/B
of two kernels in one call on one card.

``--check`` holds every entry point to its plain version over cases at the
edges of 64-row tiles, at every head width, and runs each twice for a
bitwise repeat: B1 with windows of 1, 8 and 100 and ragged ``seq_len``
(rows that see no key must give O = 0 and L = -1e30), in bf16 O within
1e-2 and L within 1e-5, in float32 O and L within the reference's 2e-3
relative and 2e-4 absolute; B2 and B3 in bf16 within 1e-2, in float32
within the reference's 2e-3 relative and 1e-4 absolute. It prints every
case and exits non-zero if any failed. ``--save`` writes B1's outputs and
B2's and B3's in both dtypes on fixed inputs, B2 and B3 fed the L of B1's
plain version (run on the card), so that a backward key depends on B2 or
B3 alone; ``--compare`` says whether two such files are equal bit for bit,
key by key, and exits non-zero if a float32 B1 key or a bf16 key differs
(the float32 B2 and B3 may change their bits by design). Needs CUDA except
for ``--compare``.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from typing import Dict, List, Optional

import torch

PATHS = {"paper_95m": (6, 256, 64), "qwen3_0_6b": (16, 256, 128)}
# tests/test_torch_cuda.py's gates for the bf16 entry points: O, dQ, dK, dV; L
BF16_TOL, BF16_L_TOL = 1e-2, 1e-5
# the float32 B1 against its plain version: the reference's forward parity,
# O and L (tests/test_kernels.py:87)
FWD_RTOL, FWD_ATOL = 2e-3, 2e-4
SLEEP_CYCLES = 50_000_000  # longer than the host takes to enqueue the timed calls
REPS = 30
# (BH, S, dh), window: 64-row tiles' edges (S = 64, 65, 127, 129, 320), a
# window within one tile, ragged windowed lengths, at every head width
CHECK_CASES = [((2, S, dh), w) for dh in (16, 32, 64, 128)
               for S, w in ((64, None), (65, None), (127, None), (129, 8), (320, None),
                            (200, 100), (256, 8))]
# B1's cases, (BH, S, dh), window, seq_len: one tile, a row past it, a row
# short of two (window 1: each row sees itself), a row past two (window 8),
# a window across tiles, 5 tiles, and keys past seq_len (150, 100, 0) that
# leave rows seeing no key, at every head width
FWD_CHECK_CASES = [((2, S, dh), w, n) for dh in (16, 32, 64, 128)
                   for S, w, n in ((64, None, None), (65, None, None), (127, 1, None),
                                   (129, 8, None), (200, 100, None), (320, None, None),
                                   (200, 8, 150), (129, 1, 100), (65, None, 0))]
# B2's and B3's float32 cases, (BH, S, dh), window: one tile, a row past it,
# a row short of two (window 1), a row past two (window 8), a window across
# tiles, 5 tiles (an odd count: a key tile of B3 that 5 query tiles see) and
# a window of 8 over 3 tiles, at every head width
F32_BWD_CHECK_CASES = [((2, S, dh), w) for dh in (16, 32, 64, 128)
                       for S, w in ((64, None), (65, None), (127, 1), (129, 8), (200, 100),
                                    (320, None), (192, 8))]
# the float32 B2 and B3 against their plain versions: the reference's backward
# parity (tests/test_kernels.py:137-142)
BWD_RTOL, BWD_ATOL = 2e-3, 1e-4
SAVE_CASES = [((3, 130, 64), None), ((2, 200, 128), 100), ((2, 100, 16), 16)]


def _heads(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(4)]


def _backward_inputs(kflash, shape, dtype, window, seed, plain=False):
    """q, k, v, dO and the L and D of B1, or with ``plain`` of B1's plain
    version (on the card)."""
    q, k, v, do = _heads(shape, dtype, seed)
    fwd = kflash.flash_fwd_plain if plain else kflash.flash_fwd
    o, L = fwd(q, k, v, window=window)
    D = (do.float() * o.float()).sum(-1)
    return q, k, v, do, L, D


def _time_ms(fn, reps: int = REPS) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))


def _rel(got, want) -> float:
    """The largest relative Frobenius error of ``got``'s tensors against ``want``'s."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(float((a.double() - b).norm() / b.norm()) for a, b in zip(got, want))


def ptxas_report(log: str, kernel: str) -> Dict:
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


def _bench_kernels(kflash, x, shape) -> Dict:
    """B1, B2 and B3 on the backward inputs x = (q, k, v, dO, L, D) at
    ``shape``, beside SDPA's forward and backward in their dtype: ms per
    launch, the grid, and the relative error of O against a float64 forward
    and of dQ and of dK, dV (the larger) against a float64 backward from the
    same inputs, L and D, each beside the plain version's."""
    import torch.nn.functional as F

    q, k, v, do = x[:4]
    want_o = kflash.flash_fwd_plain(q.double(), k.double(), v.double())[0]
    out = {"flash_fwd": {"ms": _time_ms(lambda: kflash.flash_fwd(q, k, v)),
                         "blocks": kflash.launched_blocks()["flash_fwd"],
                         "rel_err_f64": _rel(kflash.flash_fwd(q, k, v)[0], want_o),
                         "plain_rel_err_f64": _rel(kflash.flash_fwd_plain(q, k, v)[0], want_o)}}
    x64 = [t.double() for t in x]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        want = getattr(kflash, name + "_plain")(*x64)
        kernel = getattr(kflash, name)
        out[name] = {"ms": _time_ms(lambda: kernel(*x)),
                     "blocks": kflash.launched_blocks()[name],
                     "rel_err_f64": _rel(kernel(*x), want),
                     "plain_rel_err_f64": _rel(getattr(kflash, name + "_plain")(*x), want)}
    out["b2_plus_b3_ms"] = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"]
    BH, S, dh = shape
    q4, k4, v4 = (t.reshape(1, BH, S, dh).clone().requires_grad_(True) for t in (q, k, v))
    with torch.no_grad():
        out["sdpa_forward_ms"] = _time_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.reshape(1, BH, S, dh)
    out["sdpa_backward_ms"] = _time_ms(
        lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True))
    return out


def bench_shape(kflash, shape) -> Dict:
    """The bf16 kernels at ``shape`` (_bench_kernels), a 16-float zero_
    launch and the TMA tensor maps' host ns; the float32 kernels under
    ``float32``."""
    from repro_torch.kernels.build import load_library

    lib = load_library().lib
    x = _backward_inputs(kflash, shape, torch.bfloat16, None, seed=4)
    out = {"shape": list(shape), **_bench_kernels(kflash, x, shape)}
    # what any launch costs timed this way: one kernel that zeroes 16 floats
    z = torch.zeros(16, device="cuda")
    out["zero_16_floats_ms"] = _time_ms(z.zero_)
    BH, S, dh = shape
    for key, fn in (("fwd_tensor_maps_ns_per_launch", "rbr_flash_fwd_bf16_maps_ns"),
                    ("tensor_maps_ns_per_launch", "rbr_flash_bwd_bf16_maps_ns")):
        maps_ns = getattr(lib, fn, None)
        if maps_ns is not None:  # the TMA route's host cost
            out[key] = maps_ns(x[0].data_ptr(), BH, S, dh, 1000)
    out["float32"] = _bench_kernels(
        kflash, _backward_inputs(kflash, shape, torch.float32, None, seed=4), shape)
    return out


def _gate_share(got, want, rtol, atol) -> float:
    """The worst element's share of the gate |err| <= atol + rtol |want|."""
    return float(((got.float() - want.float()).abs() / (atol + rtol * want.float().abs())).max())


def check_fwd(kflash, dtype) -> List[Dict]:
    """B1's entry point for ``dtype`` against its plain version on
    FWD_CHECK_CASES."""
    o_tol, l_tol = (((BF16_TOL, BF16_TOL), (BF16_L_TOL, BF16_L_TOL)) if dtype == torch.bfloat16
                    else ((FWD_RTOL, FWD_ATOL), (FWD_RTOL, FWD_ATOL)))
    rows = []
    for shape, window, seq_len in FWD_CHECK_CASES:
        q, k, v, _ = _heads(shape, dtype, seed=shape[1] + shape[2])
        kw = dict(window=window, seq_len=seq_len)
        o, L = kflash.flash_fwd(q, k, v, **kw)
        blocks = kflash.launched_blocks()["flash_fwd"]
        o2, L2 = kflash.flash_fwd(q, k, v, **kw)
        o_p, L_p = kflash.flash_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        S = shape[1]
        dead = ~kflash.visible_mask(S, S if seq_len is None else seq_len, True, window,
                                    q.device).any(-1)
        row = {"kernel": "flash_fwd", "dtype": str(dtype).split(".")[-1], "shape": list(shape),
               "window": window, "seq_len": seq_len,
               "gate_share": {"o": _gate_share(o, o_p, *o_tol), "L": _gate_share(L, L_p, *l_tol)},
               "bitwise_repeat": torch.equal(o, o2) and torch.equal(L, L2),
               "dead_rows": int(dead.sum()),
               "dead_rows_zero": bool((o[:, dead] == 0).all() and (L[:, dead] <= -1e29).all()),
               "blocks": blocks}
        row["ok"] = (max(row["gate_share"].values()) <= 1.0 and row["bitwise_repeat"]
                     and row["dead_rows_zero"])
        rows.append(row)
    return rows


def check_bwd(kflash, dtype) -> List[Dict]:
    """B2's and B3's entry points for ``dtype`` against their plain versions:
    bf16 on CHECK_CASES within 1e-2, float32 on F32_BWD_CHECK_CASES within
    the reference's tolerances."""
    cases, tol = ((CHECK_CASES, (BF16_TOL, BF16_TOL)) if dtype == torch.bfloat16
                  else (F32_BWD_CHECK_CASES, (BWD_RTOL, BWD_ATOL)))
    rows = []
    for shape, window in cases:
        x = _backward_inputs(kflash, shape, dtype, window, seed=shape[1] + shape[2])
        got = (kflash.flash_bwd_dq(*x, window=window), *kflash.flash_bwd_dkv(*x, window=window))
        again = (kflash.flash_bwd_dq(*x, window=window),
                 *kflash.flash_bwd_dkv(*x, window=window))
        want = (kflash.flash_bwd_dq_plain(*x, window=window),
                *kflash.flash_bwd_dkv_plain(*x, window=window))
        torch.cuda.synchronize()
        share = [_gate_share(a, b, *tol) for a, b in zip(got, want)]
        rows.append({"kernel": "flash_bwd", "dtype": str(dtype).split(".")[-1],
                     "shape": list(shape), "window": window,
                     "gate_share": dict(zip(("dq", "dk", "dv"), share)),
                     "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(got, again)),
                     "blocks": kflash.launched_blocks()})
        rows[-1]["ok"] = max(share) <= 1.0 and rows[-1]["bitwise_repeat"]
    return rows


def save_outputs(kflash, path: str) -> None:
    """B1's outputs, and B2's and B3's fed the plain forward's L and D."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, window in SAVE_CASES:
            x = _backward_inputs(kflash, shape, dtype, window, seed=7, plain=True)
            key = f"{dtype}/{shape}/{window}"
            out["flash_fwd/" + key] = [t.cpu() for t in kflash.flash_fwd(*x[:3], window=window)]
            out["flash_bwd/" + key] = [t.cpu() for t in (
                kflash.flash_bwd_dq(*x, window=window), *kflash.flash_bwd_dkv(*x, window=window))]
    torch.save(out, path)


def compare(a: str, b: str) -> Dict:
    x, y = torch.load(a), torch.load(b)
    return {k: all(torch.equal(p, q) for p, q in zip(x[k], y[k])) for k in x}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args(argv)
    if args.compare:
        res = compare(*args.compare)
        f32 = {kind: all(eq for key, eq in res.items()
                         if str(torch.float32) in key and key.startswith(kind))
               for kind in ("flash_fwd", "flash_bwd")}
        bf16 = all(eq for key, eq in res.items() if str(torch.bfloat16) in key)
        print(json.dumps({"bitwise_equal": res, "float32_bitwise_equal": f32,
                          "bf16_bitwise_equal": bf16}))
        return 0 if f32["flash_fwd"] and bf16 else 1
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash measures the card: it needs CUDA")
    from repro_torch.kernels import flash as kflash

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.save:
        save_outputs(kflash, args.save)
        return 0
    if args.check:
        rows = [*check_fwd(kflash, torch.float32), *check_fwd(kflash, torch.bfloat16),
                *check_bwd(kflash, torch.float32), *check_bwd(kflash, torch.bfloat16)]
        for row in rows:
            print(json.dumps(row), flush=True)
        return 0 if all(r["ok"] for r in rows) else 1
    from repro_torch.kernels.build import load_library

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    # ptxas's report of every flash kernel (empty when an earlier build was found)
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "ptxas": ptxas_report(load_library().log, "flash_")}), flush=True)
    for path, shape in PATHS.items():
        print(json.dumps({"path": path, "card": smi, **bench_shape(kflash, shape)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
