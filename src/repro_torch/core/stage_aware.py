"""Stage-aware basis-refresh frequency allocation (paper Appendix I).
Port of ``repro/core/stage_aware.py`` for the per-layer (sim) layout.

For pipeline depth P, base frequency f0 and per-stage delay tau:

    mid = floor(P/2) - 1
    n   = mid - tau          if tau > mid
          mid + 1 - tau      if tau <= mid
    f   = floor( f0 / (1 - n/mid) )

A non-positive denominator means the stage's basis is never refreshed.
``StageContext`` carries one scalar delay per parameter leaf; stage-stacked
leaves with per-stage delay tuples come with the SPMD engine.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

NEVER = 1 << 30  # finite periods are < NEVER; f >= NEVER means "never refresh"


def stage_aware_freq(tau: int, num_stages: int, base_freq: int) -> int:
    if num_stages <= 2:
        return base_freq
    mid = num_stages // 2 - 1
    if mid <= 0:
        return base_freq
    n = (mid - tau) if tau > mid else (mid + 1 - tau)
    denom = 1.0 - n / mid
    if denom <= 0:
        return NEVER
    return max(1, int(math.floor(base_freq / denom)))


def freqs_for_delays(
    delays: Sequence[int], num_stages: int, base_freq: int, reversed_allocation: bool = False
) -> List[int]:
    """Map per-leaf delays to per-leaf refresh frequencies, renormalising the
    finite periods so the total refresh count matches uniform-f0 exactly."""
    raw = []
    for tau in delays:
        t = (num_stages - 1 - tau) if reversed_allocation else tau
        raw.append(stage_aware_freq(int(t), num_stages, base_freq))
    inv_raw = sum(1.0 / f for f in raw if f < NEVER)
    inv_uniform = len(raw) / base_freq
    if inv_raw > inv_uniform > 0:
        scale = inv_raw / inv_uniform
        raw = [f if f >= NEVER else max(1, math.ceil(f * scale)) for f in raw]
    return raw


@dataclass(frozen=True)
class StageContext:
    """Per-leaf staleness metadata: ``delays[i]`` is leaf i's gradient delay,
    in the leaf order of the parameter dict."""

    num_stages: int
    delays: Tuple[int, ...]

    def refresh_freqs(self, base_freq: int, reversed_allocation: bool = False) -> List[int]:
        return freqs_for_delays(
            self.delays, self.num_stages, base_freq, reversed_allocation
        )

    def delay_specs(self) -> List[int]:
        """Per-leaf delays for the delay-FIFO wrapper."""
        return [int(d) for d in self.delays]
