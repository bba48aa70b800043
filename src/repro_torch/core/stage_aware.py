"""Stage-aware basis-refresh frequency allocation (paper Appendix I).
Port of ``repro/core/stage_aware.py``.

For pipeline depth P, base frequency f0 and per-stage delay tau:

    mid = floor(P/2) - 1
    n   = mid - tau          if tau > mid
          mid + 1 - tau      if tau <= mid
    f   = floor( f0 / (1 - n/mid) )

A non-positive denominator means the stage's basis is never refreshed.

``StageContext`` carries one delay record per parameter leaf: a scalar for a
leaf owned wholly by one stage (the sim layout, and the SPMD engine's shared
leaves) or a length-K tuple for a leaf whose leading axis is the pipeline
stage (the SPMD stage-stacked layout). Refresh periods are budget-
renormalised over the expanded per-layer multiset (``repeats``), so a
stacked ``(K, per, m, n)`` leaf gets exactly the per-(stage, layer) periods
the per-layer sim layout would. ``data_delay`` is the asynchronous data
axis's uniform extra staleness: refresh periods and delay scales read the
total delay tau + data_delay, while the FIFO specs stay pipeline-only (the
data delay is imposed by the engine's deferred-reduction FIFO, or, on the
sim backend, by deepening every leaf's queue).

A process of a multi-process SPMD run holds a slab of the stages:
``StageContext.slab(k0, k1)`` keeps each stacked leaf's delays of global
stages ``k0 .. k1-1``, and its refresh periods stay those of the whole
layout (``full``), whose budget they are normalised over.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch

NEVER = 1 << 30  # finite periods are < NEVER; f >= NEVER means "never refresh"

# an int for a leaf owned by one stage, or a tuple of per-stage values for a
# leaf whose leading axis is the stage
DelaySpec = Union[int, Tuple[int, ...]]


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


def budget(freqs: Sequence[int], steps: int) -> float:
    """Total number of basis refreshes over a run (the conserved budget)."""
    return sum(steps / f for f in freqs if f < NEVER)


@dataclass(frozen=True)
class StageContext:
    """Per-leaf staleness metadata, in the leaf order of the parameter dict.

    ``delays[i]`` is leaf i's gradient delay (int or per-stage tuple);
    ``repeats[i]`` is how many per-layer leaves each entry stands for: 1 for
    sim and shared leaves, layers-per-stage for stacked block leaves."""

    num_stages: int
    delays: Tuple[DelaySpec, ...]
    repeats: Tuple[int, ...] = ()
    data_delay: int = 0
    # the whole layout's context, for a slab of its stages (``slab``): the
    # refresh budget is normalised over it
    full: Optional["StageContext"] = None

    def __post_init__(self):
        if not self.repeats:
            object.__setattr__(self, "repeats", (1,) * len(self.delays))
        if len(self.repeats) != len(self.delays) or self.data_delay < 0:
            raise ValueError("StageContext: repeats must match delays; data_delay >= 0")

    def _expanded_delays(self) -> List[int]:
        out: List[int] = []
        for d, r in zip(self.delays, self.repeats):
            taus = d if isinstance(d, tuple) else (d,)
            out.extend(int(t) + self.data_delay for t in taus for _ in range(r))
        return out

    def refresh_freqs(self, base_freq: int,
                      reversed_allocation: bool = False) -> List[DelaySpec]:
        """Per-leaf refresh periods, shaped like ``delays``: the period of
        delay tau is the same whether tau is a scalar or a tuple's slot."""
        expanded = (self.full or self)._expanded_delays()
        flat = freqs_for_delays(expanded, self.num_stages, base_freq, reversed_allocation)
        lut = dict(zip(expanded, flat))
        return [tuple(lut[int(t) + self.data_delay] for t in d) if isinstance(d, tuple)
                else lut[int(d) + self.data_delay] for d in self.delays]

    def slab(self, k0: int, k1: int) -> "StageContext":
        """The context of the slab of global stages ``[k0, k1)``: each
        stacked leaf's per-stage delays cut to those stages (stage k keeps
        tau_k = K-1-k, not the delay of its position in the slab), scalar
        delays as they are, refresh periods from this whole layout."""
        if not 0 <= k0 < k1 <= self.num_stages:
            raise ValueError(f"stage slab [{k0}, {k1}) outside [0, {self.num_stages})")
        if self.full is not None:
            raise ValueError("slab of a slab")
        delays = tuple(d[k0:k1] if isinstance(d, tuple) else d for d in self.delays)
        return StageContext(num_stages=self.num_stages, delays=delays, repeats=self.repeats,
                            data_delay=self.data_delay, full=self)

    def delay_specs(self) -> List[Union[int, str]]:
        """Per-leaf specs for the delay FIFOs: ``"stage"`` for stage-stacked
        leaves, the scalar pipeline delay otherwise."""
        return ["stage" if isinstance(d, tuple) else int(d) for d in self.delays]

    def delay_scales(self, params) -> List[Union[int, torch.Tensor]]:
        """Per-leaf total delays (pipeline tau + ``data_delay``), each
        broadcastable over its leaf of ``params`` (ordered dict): an int, or a
        ``(K, 1, ..., 1)`` float32 tensor over a stacked leaf's stage axis, on
        the leaf's device (on the CPU for a weightless meta-device leaf; its
        consumers copy it to the device of the leaf it multiplies)."""
        if len(params) != len(self.delays):
            raise ValueError("context must match leaf count")
        out: List[Union[int, torch.Tensor]] = []
        for p, d in zip(params.values(), self.delays):
            if isinstance(d, tuple):
                if p.shape[0] != len(d):
                    raise ValueError(f"stacked leaf {tuple(p.shape)} has no {len(d)}-stage axis")
                dev = "cpu" if p.device.type == "meta" else p.device
                t = torch.tensor([x + self.data_delay for x in d], dtype=torch.float32,
                                 device=dev)
                out.append(t.reshape((len(d),) + (1,) * (p.ndim - 1)))
            else:
                out.append(int(d) + self.data_delay)
        return out
