"""Measured-timing tuner backend: warmup, then the median of k runs on the
card. Port of ``repro/tune/measure.py``.

This is the backend that takes over from the cost model on a card
(``python -m repro_torch.tune --measure``, the default where CUDA is
available): every candidate launch shape is timed on the device between
CUDA events, and the cache records the winner. Each run waits behind a
sleep kernel, so the host's cost of issuing it is not timed, and is
synchronised before the next. There is no interpret mode to time off the
card, so every function here raises on a host without one; nothing times
the plain versions in its place.
"""
from __future__ import annotations

import statistics
from typing import Any, Callable, Dict, List, Sequence

import torch

# ~25 ms at 2 GHz: longer than the host takes to enqueue one grouped B5 launch
SLEEP_CYCLES = 50_000_000
# written between the runs of a cold timing: twice an H100's 50 MB of L2
L2_FLUSH_BYTES = 100 * 2 ** 20
# beta2, eps and the bias corrections at step 4, as chip_smoke.py times B5
ADAM_SCALARS = (0.999, 1e-8, 1 - 0.9 ** 4, 1 - 0.999 ** 4)


def _need_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch.tune.measure times kernels on a CUDA card, and "
                           "torch.cuda.is_available() is false on this host")


def measure_us(fn: Callable, *args, iters: int = 10, warmup: int = 2,
               flush: bool = False) -> float:
    """Median device microseconds of ``fn(*args)`` over ``iters`` runs after
    ``warmup``, each between its own pair of CUDA events behind a sleep
    kernel and synchronised; with ``flush`` the L2 is overwritten before
    each run (a cold timing)."""
    _need_card()
    for _ in range(max(warmup, 1)):
        fn(*args)
    torch.cuda.synchronize()
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if flush else None
    samples: List[float] = []
    for _ in range(max(iters, 1)):
        if scratch is not None:
            scratch.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        samples.append(1e3 * start.elapsed_time(end))
    return statistics.median(samples)


def _adam_leaves(shapes: Sequence[Sequence[int]], seed: int = 0):
    """g, m, v of their own for each leaf, at the sizes of a rotated step."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gs, ms, vs = [], [], []
    for shape in shapes:
        gs.append(torch.randn(tuple(shape), device="cuda", generator=gen) * 1e-3)
        ms.append(torch.randn(tuple(shape), device="cuda", generator=gen) * 1e-3)
        vs.append(torch.randn(tuple(shape), device="cuda", generator=gen).abs() * 1e-6 + 1e-8)
    return gs, ms, vs


def best_adam_chunk_measured(shapes: Sequence[Sequence[int]], *, iters: int = 10,
                             warmup: int = 2) -> Dict[str, Any]:
    """Time B5's grouped launch over leaves of ``shapes`` cold at every
    chunk it takes; return the fastest, every candidate's time and the
    rule's chunk. Every chunk must give the same bits as the rule's."""
    from repro_torch.kernels import adam_step
    from repro_torch.tune.cost_model import adam_chunks

    _need_card()
    gs, ms, vs = _adam_leaves(shapes)
    elements = sum(g.numel() for g in gs)
    rule = adam_step.chunk_size(elements)
    want = adam_step.adam_scale_grouped(gs, ms, vs, *ADAM_SCALARS, chunk=rule)
    candidates = {}
    for chunk in adam_chunks():
        got = adam_step.adam_scale_grouped(gs, ms, vs, *ADAM_SCALARS, chunk=chunk)
        if not all(torch.equal(a, b) for x, y in zip(got, want) for a, b in zip(x, y)):
            raise AssertionError(f"adam_scale: chunk {chunk} gives other bits than chunk {rule}")
        del got
        candidates[chunk] = measure_us(
            lambda c=chunk: adam_step.adam_scale_grouped(gs, ms, vs, *ADAM_SCALARS, chunk=c),
            iters=iters, warmup=warmup, flush=True)
    best = min(candidates, key=lambda c: (candidates[c], -c))
    return {"chunk": best, "us": candidates[best], "rule_chunk": rule,
            "candidates_us": {str(c): us for c, us in candidates.items()},
            "leaves": len(gs), "elements": elements, "bitwise_equal": True,
            "backend": "measured"}


def measure_flash_plan(S: int, dh: int, *, batch_heads: int = 1, dtype: str = "float32",
                       causal: bool = True, iters: int = 10, warmup: int = 2) -> float:
    """Measured forward plus backward microseconds of B1-B3 (through
    ``flash_attention``, so a width outside the built ones runs padded) on
    (1, batch_heads, S, dh) heads."""
    from repro_torch.kernels.flash import flash_attention

    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((1, batch_heads, S, dh), device="cuda", generator=gen)
                   .to(getattr(torch, dtype)) for _ in range(4))
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    with torch.no_grad():
        us_f = measure_us(lambda: flash_attention(q, k, v, causal=causal), iters=iters,
                          warmup=warmup)
    out = flash_attention(q, k, v, causal=causal)
    us_b = measure_us(lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True),
                      iters=iters, warmup=warmup)
    return us_f + us_b


def measure_matmul_plan(m: int, n: int, k: int, *, iters: int = 10, warmup: int = 2) -> float:
    """Measured microseconds of B4 at (m, k) x (k, n) in float32."""
    from repro_torch.kernels import matmul as kmm

    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((m, k), device="cuda", generator=gen) / k ** 0.5
    b = torch.randn((k, n), device="cuda", generator=gen)
    return measure_us(lambda: kmm.matmul(a, b), iters=iters, warmup=warmup)
