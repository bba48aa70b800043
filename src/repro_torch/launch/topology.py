"""The (pod, stage, data) shape of one pipeline deployment. Port of
``repro/launch/topology.py`` without its mesh and ``PartitionSpec`` half,
which has no torch meaning.

Shape, as in the reference (the pod axis only when there are pods):

    pods == 1 :  (stage, data)
    pods >= 2 :  (pod, stage, data)

A position of that grid is one (stage, data replica) of the pipeline. One
process runs every position of its slab: the whole grid in a single-process
run, and in a multi-process run the equal, process-major slab of the
row-major grid that the reference's ``_process_coords`` assigns
(``process_slab``). From that follow the data shards whose microbatch rows
a process supplies (``process_data_shards``), the process that writes each
checkpoint shard (``shard_owners``) and the groups of processes whose
gradients are summed (``replica_groups``, as positions of the grid).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

STAGE_AXIS = "stage"
DATA_AXIS = "data"
POD_AXIS = "pod"


@dataclass(frozen=True)
class Slab:
    """One process's block of the grid: the half-open stage range and data
    shard range (pod-major over ``(pod, data)``) whose positions it runs."""

    stages: Tuple[int, int]
    data_shards: Tuple[int, int]


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
    def axis_names(self) -> Tuple[str, ...]:
        if self.pods == 1:
            return (STAGE_AXIS, DATA_AXIS)
        return (POD_AXIS, STAGE_AXIS, DATA_AXIS)

    @property
    def num_devices(self) -> int:
        """Positions of the grid (devices, in the reference)."""
        return self.pods * self.stages * self.data

    @property
    def data_shards(self) -> int:
        """Ways each microbatch's rows split: the full (pod, data) extent."""
        return self.pods * self.data

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Axes that carry data parallelism (the gradient reduction's)."""
        if self.pods == 1:
            return (DATA_AXIS,)
        return (POD_AXIS, DATA_AXIS)

    def describe(self) -> str:
        return "x".join(str(s) for s in self.shape)

    def replica_groups(self, axes: Tuple[str, ...]) -> Tuple[Tuple[int, ...], ...]:
        """Groups of a reduction over ``axes``, as flattened positions of the
        row-major grid: the positions that share their coordinates on the
        other axes."""
        unknown = set(axes) - set(self.axis_names)
        if not axes or unknown:
            raise ValueError(
                f"axes {axes} not declared by topology {self.describe()} "
                f"with axes {self.axis_names}"
            )
        names = self.axis_names
        keep = [i for i, n in enumerate(names) if n not in axes]
        move = [i for i, n in enumerate(names) if n in axes]
        ids = np.arange(self.num_devices).reshape(self.shape)
        grouped = ids.transpose(keep + move).reshape(
            -1, int(np.prod([self.shape[i] for i in move]))
        )
        return tuple(tuple(int(x) for x in row) for row in grouped)

    # -- process grid (multi-process) ----------------------------------------

    def local_device_count(self, num_processes: int) -> int:
        """Positions each process runs: the grid split into equal
        process-major slabs."""
        if num_processes < 1 or self.num_devices % num_processes != 0:
            raise ValueError(
                f"{self.num_devices} devices of topology {self.describe()} "
                f"do not split over {num_processes} processes"
            )
        return self.num_devices // num_processes

    def _process_coords(self, num_processes: int, process_index: int) -> np.ndarray:
        """(pod, stage, data)-style coordinate rows of one process's slab of
        the row-major grid."""
        per = self.local_device_count(num_processes)
        if not 0 <= process_index < num_processes:
            raise ValueError(
                f"process_index {process_index} out of range for "
                f"{num_processes} processes"
            )
        flat = np.arange(process_index * per, (process_index + 1) * per)
        return np.stack(np.unravel_index(flat, self.shape), axis=1)

    def _stage_and_shard(self, coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self.pods == 1:
            return coords[:, 0], coords[:, 1]
        return coords[:, 1], coords[:, 0] * self.data + coords[:, 2]

    def process_data_shards(
        self, num_processes: int, process_index: int
    ) -> Tuple[int, int]:
        """Half-open range ``[lo, hi)`` of global data-shard indices (pod-
        major, ``data_shards`` in all) whose microbatch rows this process
        supplies. Processes that hold only stage replicas of the same rows
        get overlapping ranges."""
        _, rows = self._stage_and_shard(self._process_coords(num_processes, process_index))
        uniq = sorted(set(int(r) for r in rows))
        lo, hi = uniq[0], uniq[-1] + 1
        if uniq != list(range(lo, hi)):
            raise ValueError(
                f"process {process_index}/{num_processes} of topology "
                f"{self.describe()} owns non-contiguous data shards {uniq}; "
                f"choose a process count whose slab size divides (or is a "
                f"multiple of) the data extent"
            )
        return lo, hi

    def process_slab(self, num_processes: int, process_index: int) -> Slab:
        """The block of the grid one process runs: its stage range and data
        shard range. Raises when the process's positions are not such a
        block (a slab that cuts a stage's data extent unevenly)."""
        lo, hi = self.process_data_shards(num_processes, process_index)
        stages, _ = self._stage_and_shard(self._process_coords(num_processes, process_index))
        k0, k1 = int(stages.min()), int(stages.max()) + 1
        if (k1 - k0) * (hi - lo) != self.local_device_count(num_processes):
            raise ValueError(
                f"process {process_index}/{num_processes} of topology {self.describe()} "
                f"holds stages [{k0}, {k1}) and data shards [{lo}, {hi}) but not their "
                f"whole block; choose a process count whose slab size divides (or is a "
                f"multiple of) the data extent")
        return Slab(stages=(k0, k1), data_shards=(lo, hi))

    def shard_owners(self, num_processes: int) -> Tuple[int, ...]:
        """Which process writes checkpoint shard (= pipeline stage) ``s``:
        round-robin over the processes whose slab touches stage ``s``, so
        pod-replicated layouts spread the writes. Exactly one owner a shard."""
        owners = []
        self.local_device_count(num_processes)  # validate divisibility
        by_stage: dict = {}
        for p in range(num_processes):
            stages, _ = self._stage_and_shard(self._process_coords(num_processes, p))
            for s in stages:
                by_stage.setdefault(int(s), []).append(p)
        for s in range(self.stages):
            cands = sorted(set(by_stage[s]))
            owners.append(cands[s % len(cands)])
        return tuple(owners)

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

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_device_count(
        cls, stages: int, pods: int = 1, data: int = 0,
        device_count: Optional[int] = None,
    ) -> "Topology":
        """Fill in the data axis from the device count: ``data == 0`` means
        every device, data = n // (pods * stages). The port has no visible
        device grid to read, so ``device_count`` is required then."""
        if data <= 0:
            if device_count is None:
                raise ValueError("data == 0 needs the device_count to fill it from")
            if device_count % (pods * stages) != 0:
                raise ValueError(
                    f"{device_count} devices not divisible by pods*stages = "
                    f"{pods}*{stages}"
                )
            data = device_count // (pods * stages)
        return cls(stages=stages, data=data, pods=pods)

    @classmethod
    def from_process_grid(
        cls, stages: int, num_processes: int, local_device_count: int,
        pods: int = 1, data: int = 0,
    ) -> "Topology":
        """Multi-process constructor: the grid is the union of
        ``num_processes`` slabs of ``local_device_count`` positions each;
        ``data == 0`` fills the data axis from that total."""
        return cls.from_device_count(
            stages, pods=pods, data=data,
            device_count=num_processes * local_device_count,
        )
