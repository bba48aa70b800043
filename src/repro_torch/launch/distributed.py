"""Multi-process (``torch.distributed``) initialisation, process identity and
the transport between ranks. Port of ``repro/launch/distributed.py``.

One process per slab of the (pod, stage, data) grid: ``launch/spawn.py`` (or
a cluster scheduler) starts N copies of the same trainer, each owning the
slab ``Topology.process_slab`` gives it. This module is the one place that
knows

* whether the process is part of a multi-process run at all (the
  ``REPRO_*`` environment contract spawn sets, or explicit arguments),
* its coordinates (``process_index`` / ``process_count`` / ``is_main``),
* how to rendezvous by name (``barrier``),
* how tensors travel between ranks (``Transport``).

Every helper gives the single-process answer when no process group exists,
so a single-process run is unchanged. torch is imported where it is used:
the launcher (``launch/spawn.py``) reads the environment contract alone.

``barrier`` is not a process-group collective. The checkpoint writer thread
runs barriers while the loop thread runs the step's collectives, and gloo
cannot have two collectives of one process in flight. It is built on the
``TCPStore`` that ``init_process_group`` is given: a counter key per barrier
name, then a wait on that name's release key. Two ranks saving different
steps wait at different names and fail by timeout instead of mixing their
messages.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from datetime import timedelta
from typing import TYPE_CHECKING, Dict, List, MutableMapping, Optional, Sequence, Tuple

if TYPE_CHECKING:
    import torch

# env contract between launch/spawn.py and the worker processes
ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"

# how long a rank waits at a barrier or in a collective before it fails
TIMEOUT = timedelta(seconds=600)


@dataclass(frozen=True)
class ProcessGrid:
    """Resolved multi-process coordinates of THIS process."""

    num_processes: int = 1
    process_index: int = 0
    coordinator: Optional[str] = None

    def __post_init__(self):
        if self.num_processes < 1:
            raise ValueError(f"num_processes must be >= 1, got {self}")
        if not 0 <= self.process_index < self.num_processes:
            raise ValueError(f"process_index out of range: {self}")

    @property
    def distributed(self) -> bool:
        return self.num_processes > 1

    def describe(self) -> str:
        return f"process {self.process_index}/{self.num_processes}"


def distributed_env(
    env: Optional[MutableMapping[str, str]] = None,
) -> Optional[ProcessGrid]:
    """The ``ProcessGrid`` a launcher requested through the environment, or
    None outside one. All three variables must be present: a partial
    contract is a launcher bug, reported instead of running single-process."""
    if env is None:
        env = os.environ
    keys = (ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID)
    present = [k for k in keys if k in env]
    if not present:
        return None
    if len(present) != len(keys):
        missing = sorted(set(keys) - set(present))
        raise RuntimeError(
            f"partial multi-controller env: {present} set but {missing} "
            f"missing (launch/spawn.py sets all three)"
        )
    return ProcessGrid(
        num_processes=int(env[ENV_NUM_PROCESSES]),
        process_index=int(env[ENV_PROCESS_ID]),
        coordinator=env[ENV_COORDINATOR],
    )


def split_address(coordinator: str) -> Tuple[str, int]:
    """``host:port`` (or ``tcp://host:port``) -> (host, port)."""
    addr = coordinator[len("tcp://"):] if coordinator.startswith("tcp://") else coordinator
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r} is not host:port")
    return host, int(port)


@dataclass
class _Runtime:
    """What ``init_distributed`` set up in this process."""

    grid: ProcessGrid
    address: Tuple[str, int]
    store: "torch.distributed.Store"
    transport: "Transport"
    barrier_s: List[float] = field(default_factory=list)


_RUNTIME: Optional[_Runtime] = None
_LOCAL = threading.local()  # one store client per thread (the writer has its own)


def init_distributed(grid: Optional[ProcessGrid] = None,
                     device: Optional[torch.device] = None,
                     transport: str = "auto") -> ProcessGrid:
    """Join the process group of ``grid`` (default: the environment's).

    No-op, returning the single-process grid, when no multi-process launch
    was asked for. Otherwise rank 0 serves a ``TCPStore`` at the
    coordinator's address, every rank joins ``init_process_group`` over it
    with the backend that ``devices.choose_transport`` picks for
    ``device`` (each rank's own, from ``devices.rank_device``), and the
    choice is printed on the rank's first line. Call once per process."""
    global _RUNTIME
    if grid is None:
        grid = distributed_env()
    if grid is None or not grid.distributed:
        return grid or ProcessGrid()
    if grid.coordinator is None:
        raise ValueError(f"multi-process grid needs a coordinator: {grid}")
    if _RUNTIME is not None:
        raise RuntimeError("init_distributed was already called in this process")
    import torch
    import torch.distributed as dist

    from repro_torch.launch.devices import choose_transport

    device = torch.device("cpu") if device is None else torch.device(device)
    backend, staged, why = choose_transport(device, grid.num_processes, transport)
    host, port = split_address(grid.coordinator)
    store = dist.TCPStore(host, port, world_size=grid.num_processes,
                          is_master=grid.process_index == 0, timeout=TIMEOUT)
    dist.init_process_group(backend, store=store, rank=grid.process_index,
                            world_size=grid.num_processes, timeout=TIMEOUT,
                            device_id=device if backend == "nccl" else None)
    print(f"[{grid.describe()}] device={device} transport={backend}"
          f"{' (host-staged)' if staged else ''}: {why}", flush=True)
    _RUNTIME = _Runtime(grid, (host, port), store, Transport(backend, device, staged))
    return grid


def shutdown() -> None:
    """Leave the process group (a no-op in a single-process run)."""
    global _RUNTIME
    if _RUNTIME is None:
        return
    import torch.distributed as dist

    dist.destroy_process_group()
    _RUNTIME = None


def process_count() -> int:
    """Global process count (1 when no process group was initialised)."""
    return _RUNTIME.grid.num_processes if _RUNTIME is not None else 1


def process_index() -> int:
    return _RUNTIME.grid.process_index if _RUNTIME is not None else 0


def is_main() -> bool:
    """True on the process that owns logging, metrics files and manifests."""
    return process_index() == 0


def transport() -> "Transport":
    """This process's transport; raises outside a multi-process run."""
    if _RUNTIME is None:
        raise RuntimeError("no process group: init_distributed was not called")
    return _RUNTIME.transport


def barrier_waits() -> List[float]:
    """Seconds each barrier of this process waited, in order."""
    return list(_RUNTIME.barrier_s) if _RUNTIME is not None else []


def _store_client():
    """A store client of this thread's own: the writer thread's barriers
    never share a connection with the loop thread."""
    client = getattr(_LOCAL, "client", None)
    if client is None:
        import torch.distributed as dist

        host, port = _RUNTIME.address
        client = dist.TCPStore(host, port, is_master=False, timeout=TIMEOUT)
        _LOCAL.client = client
    return client


def barrier(name: str) -> None:
    """Block until every process reaches the barrier called ``name``.

    Single-process: returns at once. Multi-process: each rank adds one to
    the key ``barrier/<name>``; the rank that brings it to the process count
    sets ``barrier/<name>/go``, which every rank waits for (``TIMEOUT``)."""
    if _RUNTIME is None:
        return
    t0 = time.perf_counter()
    store = _store_client()
    key = f"barrier/{name}"
    if store.add(key, 1) == _RUNTIME.grid.num_processes:
        store.set(f"{key}/go", "1")
    store.wait([f"{key}/go"], TIMEOUT)
    _RUNTIME.barrier_s.append(time.perf_counter() - t0)


def assert_process_slabs(topology, num_processes: int) -> None:
    """Check the port's rank-to-slab map: every rank's positions of the
    row-major (pod, stage, data) grid form one contiguous slab that is a
    stage range times a data-shard range, and the slabs partition the grid.
    The engine's stage split, its data groups, the process-local batches and
    the checkpoint's shard owners all assume it."""
    if num_processes == 1:
        return
    seen = set()
    for p in range(num_processes):
        slab = topology.process_slab(num_processes, p)
        cells = {(s, d) for s in range(*slab.stages) for d in range(*slab.data_shards)}
        if len(cells) != topology.local_device_count(num_processes) or cells & seen:
            raise RuntimeError(f"process {p}'s slab {slab} of topology {topology.describe()} "
                               f"is not a block of the grid")
        seen |= cells
    if len(seen) != topology.stages * topology.data_shards:
        raise RuntimeError(f"the slabs of {num_processes} processes do not cover topology "
                           f"{topology.describe()}")


class Transport:
    """How tensors travel between ranks: point-to-point activations and
    their gradients at stage boundaries, and sums over groups of ranks.

    ``staged=True`` (gloo for ranks that share a card) copies every tensor
    to a host buffer before it goes out and back to the device after it
    arrives: gloo's ``send`` / ``recv`` take CPU tensors only. Otherwise the
    tensors go as they are (NCCL device to device, or gloo on the CPU).
    ``bytes_sent`` counts the payload this rank sent, point to point and
    into sums alike; the engine reads it per step. ``recorder``, None unless
    an audit sets one (``analysis.collectives.TransportRecorder``), logs
    every exchange and every sum that communicates."""

    def __init__(self, backend: str, device: torch.device, staged: bool):
        self.backend, self.device, self.staged = backend, device, staged
        self.bytes_sent = 0
        self.recorder = None
        self._groups: Dict[Tuple[int, ...], object] = {}

    def group(self, ranks: Sequence[int]):
        """The process group of ``ranks`` (None: the whole world). Every
        rank must ask for every group, in the same order: ``new_group`` is
        collective."""
        import torch.distributed as dist

        ranks = tuple(sorted(ranks))
        if len(ranks) == dist.get_world_size():
            return None
        if ranks not in self._groups:
            self._groups[ranks] = dist.new_group(list(ranks))
        return self._groups[ranks]

    def _out(self, x: "torch.Tensor") -> "torch.Tensor":
        x = x.detach().contiguous()
        return x.cpu() if self.staged else x

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int]],
                 recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
        """Post every send ``(tensor, dst)`` and receive ``(buffer, src)`` at
        once and wait for all of them; received values are written into
        the buffers. Tensors between one pair of ranks match in order (the
        k-th send to a rank carries tag k, as does the k-th receive from
        it)."""
        import torch
        import torch.distributed as dist

        if not sends and not recvs:
            return
        if self.recorder is not None:
            self.recorder.exchange(sends, recvs)
        ops, landing, tags = [], [], {}
        for x, dst in sends:
            out = self._out(x)
            self.bytes_sent += out.numel() * out.element_size()
            tag = tags[("to", dst)] = tags.get(("to", dst), -1) + 1
            ops.append(dist.P2POp(dist.isend, out, dst, tag=tag))
        for buf, src in recvs:
            into = torch.empty(buf.shape, dtype=buf.dtype) if self.staged else buf
            landing.append((buf, into))
            tag = tags[("from", src)] = tags.get(("from", src), -1) + 1
            ops.append(dist.P2POp(dist.irecv, into, src, tag=tag))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for buf, into in landing:
            if into is not buf:
                buf.copy_(into)

    def sum_(self, tensors: Sequence[torch.Tensor], ranks: Sequence[int]) -> None:
        """Sum each tensor over ``ranks`` in place (one flat buffer a call).
        A rank outside ``ranks`` must not call it; a group of one returns."""
        self.sum_async(tensors, ranks, _deferred=False).wait()

    def sum_async(self, tensors: Sequence[torch.Tensor], ranks: Sequence[int],
                  _deferred: bool = True) -> "PendingSum":
        """Start ``sum_(tensors, ranks)`` without waiting for it: the sums
        land in the tensors when the returned ``PendingSum`` is waited for,
        and until then nothing may read or write them."""
        import torch
        import torch.distributed as dist

        if len(ranks) == 1 or not tensors:
            return PendingSum(None, None, tensors, self.device)
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        flat = flat.cpu() if self.staged else flat
        self.bytes_sent += flat.numel() * flat.element_size()
        if self.recorder is not None:
            self.recorder.sum_(ranks, flat.numel() * flat.element_size(), deferred=_deferred)
        work = dist.all_reduce(flat, group=self.group(ranks), async_op=True)
        return PendingSum(work, flat, tensors, self.device)


class PendingSum:
    """A sum over ranks in flight (``Transport.sum_async``)."""

    def __init__(self, work, flat: Optional["torch.Tensor"], tensors: Sequence["torch.Tensor"],
                 device: "torch.device"):
        self._work, self._flat, self.tensors, self._device = work, flat, list(tensors), device

    def wait(self) -> List["torch.Tensor"]:
        """Wait for the sum and write it into the tensors (once); returns them."""
        if self._work is not None:
            self._work.wait()
            flat = self._flat.to(self._device)
            at = 0
            for t in self.tensors:
                n = t.numel()
                t.copy_(flat[at:at + n].view(t.shape))
                at += n
            self._work = self._flat = None
        return self.tensors
