"""The (pod, stage, data) shape of one pipeline deployment. Port of the
single-process part of ``repro/launch/topology.py``.

The reference builds a device mesh from it; on one card the port runs every
stage and every data replica in one process, so there is no mesh, no
process grid and no collective group here, only the shape and what follows
from it: the number of data shards the microbatch rows split over
(pod-major over ``(pod, data)``) and the rows of each microbatch that
replica r takes.

Shape, as in the reference (the pod axis only when there are pods):

    pods == 1 :  (stage, data)
    pods >= 2 :  (pod, stage, data)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Topology:
    """(pod, stage, data) shape of one SPMD pipeline deployment."""

    stages: int
    data: int = 1
    pods: int = 1

    def __post_init__(self):
        if self.stages < 1 or self.data < 1 or self.pods < 1:
            raise ValueError(f"all topology axes must be >= 1, got {self}")

    @property
    def shape(self) -> Tuple[int, ...]:
        if self.pods == 1:
            return (self.stages, self.data)
        return (self.pods, self.stages, self.data)

    @property
    def data_shards(self) -> int:
        """Ways each microbatch's rows split: the full (pod, data) extent."""
        return self.pods * self.data

    def describe(self) -> str:
        return "x".join(str(s) for s in self.shape)

    def replica_rows(self, replica: int, microbatch_size: int) -> Tuple[int, int]:
        """Half-open row range ``[lo, hi)`` of each microbatch that data
        replica ``replica`` (pod-major: pod * data + data index) takes."""
        R = self.data_shards
        if not 0 <= replica < R:
            raise ValueError(f"replica {replica} out of range for {R} data shards")
        if microbatch_size % R:
            raise ValueError(f"microbatch size {microbatch_size} must divide over the {R} "
                             f"data shards of topology {self.describe()}")
        w = microbatch_size // R
        return replica * w, (replica + 1) * w
