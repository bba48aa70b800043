"""Collective audit: record the transport's calls, check their process
groups. Port of ``repro/analysis/hlo.py``.

The reference parses XLA's optimized HLO text for its collectives
(``parse_collectives``, ``collective_stats`` over the text, the iota
replica-group form, ``parse_input_output_aliases``); those parsers have no
torch meaning. The port's collectives are the calls of
``launch.distributed.Transport``: ``exchange`` (point to point: a
``collective-permute``) and ``sum_`` / ``sum_async`` (an ``all-reduce``
over a group of ranks). A ``TransportRecorder`` set on the transport logs
each call with its bytes: an exchange as its (source, target) rank pairs, a
sum as its rank group, tagged ``"step"`` when the caller waits for it and
``"reduce"`` when it is issued without waiting (the deferred data
reduction, the reference's separate reduce program). Nothing is recorded
unless an audit sets the recorder.

``instructions`` turns every rank's records into the reference's
``CollectiveInstr``: ranks map to the flattened (pod, stage, data) device
position of their slab (``Topology.process_slab``; the audits run one rank
per position, so the map is one to one), the k-th sum of every rank is one
instruction whose replica groups are the ranks' groups, and each exchange
is one permute. The checks are the reference's, on those instructions:

* every ``all-reduce`` runs over the groups of exactly one declared axis
  subset (``declared_groupings``), every permute along the stage axis only
  (``check_collective_axes``);
* the data-axes gradient all-reduce is present iff the topology splits the
  data, and absent from the step when it is deferred
  (``check_data_reduction``, ``check_async_step_reduction``);
* a donated step keeps every parameter's and optimizer-state tensor's
  storage (``check_donation``, on ``storage_ptrs`` before and after: the
  port's counterpart of the reference's input-output aliasing).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.dtype import CheckResult, state_leaves

COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, int] = field(default_factory=dict)
    count_by_op: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


@dataclass
class CollectiveInstr:
    """One collective: its op, its bytes, and its replica groups or
    source-target pairs as flattened device positions."""

    op: str
    out_bytes: int
    replica_groups: Optional[Tuple[Tuple[int, ...], ...]] = None
    source_target_pairs: Optional[Tuple[Tuple[int, int], ...]] = None
    line: str = ""


# ---------------------------------------------------------------------------
# Recording the transport
# ---------------------------------------------------------------------------


class TransportRecorder:
    """Logs one rank's transport calls while set as ``Transport.recorder``:
    dicts with ``op``, ``bytes``, ``phase`` (``"step"`` or ``"reduce"``) and
    ``group`` (a sum's ranks) or ``pairs`` (an exchange's (source, target)
    ranks)."""

    def __init__(self, rank: int):
        self.rank = rank
        self.records: List[Dict[str, Any]] = []

    def exchange(self, sends, recvs) -> None:
        pairs = [(self.rank, int(dst)) for _x, dst in sends] + \
                [(int(src), self.rank) for _b, src in recvs]
        nbytes = sum(x.numel() * x.element_size() for x, _ in sends)
        self.records.append({"op": "collective-permute", "bytes": nbytes, "phase": "step",
                             "pairs": pairs})

    def sum_(self, ranks: Sequence[int], nbytes: int, deferred: bool) -> None:
        self.records.append({"op": "all-reduce", "bytes": int(nbytes),
                             "phase": "reduce" if deferred else "step",
                             "group": sorted(int(r) for r in ranks)})


def rank_positions(topology: Any, num_processes: int) -> Dict[int, int]:
    """Rank -> the flattened (pod, stage, data) device position of its slab;
    one position a rank (``num_processes == topology.num_devices``)."""
    if topology.local_device_count(num_processes) != 1:
        raise ValueError(f"the collective audit runs one rank per device position: "
                         f"{num_processes} processes for topology {topology.describe()}")
    out = {}
    for p in range(num_processes):
        slab = topology.process_slab(num_processes, p)
        k, d = slab.stages[0], slab.data_shards[0]  # d: pod-major over (pod, data)
        coords = (k, d) if topology.pods == 1 else (d // topology.data, k, d % topology.data)
        out[p] = int(np.ravel_multi_index(coords, topology.shape))
    return out


def instructions(records_by_rank: Mapping[int, Sequence[Dict[str, Any]]], topology: Any,
                 phase: Optional[str] = None) -> List[CollectiveInstr]:
    """The ranks' records (of ``phase``, or all) as collective instructions
    over device positions: the k-th sum of each rank is one all-reduce
    whose groups are the ranks' groups; each exchange is one permute."""
    pos = rank_positions(topology, len(records_by_rank))
    out: List[CollectiveInstr] = []
    sums: Dict[int, List[Dict[str, Any]]] = {}
    for rank in sorted(records_by_rank):
        k = 0
        for r in records_by_rank[rank]:
            if phase is not None and r["phase"] != phase:
                continue
            if r["op"] == "all-reduce":
                sums.setdefault(k, []).append(r)
                k += 1
            else:
                out.append(CollectiveInstr(
                    op=r["op"], out_bytes=r["bytes"],
                    source_target_pairs=tuple((pos[s], pos[t]) for s, t in r["pairs"]),
                    line=f"rank {rank} {r['phase']} exchange {r['pairs']}"))
    for k in sorted(sums):
        groups = sorted({tuple(sorted(pos[x] for x in r["group"])) for r in sums[k]})
        out.append(CollectiveInstr(
            op="all-reduce", out_bytes=max(r["bytes"] for r in sums[k]),
            replica_groups=tuple(groups),
            line=f"sum #{k} ({sums[k][0]['phase']}) over groups {groups}"))
    return out


def collective_stats(instrs: Sequence[CollectiveInstr]) -> CollectiveStats:
    """Bytes and counts by op of the instructions."""
    stats = CollectiveStats()
    for ins in instrs:
        stats.bytes_by_op[ins.op] = stats.bytes_by_op.get(ins.op, 0) + ins.out_bytes
        stats.count_by_op[ins.op] = stats.count_by_op.get(ins.op, 0) + 1
    return stats


# ---------------------------------------------------------------------------
# Topology-declared groupings
# ---------------------------------------------------------------------------


Grouping = FrozenSet[FrozenSet[int]]


def _normalize(groups: Sequence[Sequence[int]]) -> Grouping:
    return frozenset(frozenset(g) for g in groups)


def declared_groupings(topology: Any) -> Dict[Tuple[str, ...], Grouping]:
    """Every replica grouping the topology declares: one per non-empty
    subset of its axes (a reduction over that subset partitions the
    positions by their coordinates on the remaining axes)."""
    names = topology.axis_names
    out: Dict[Tuple[str, ...], Grouping] = {}
    for r in range(1, len(names) + 1):
        for subset in itertools.combinations(names, r):
            out[subset] = _normalize(topology.replica_groups(subset))
    return out


def _device_coords(topology: Any) -> Dict[int, Tuple[int, ...]]:
    """Flattened device position -> (pod, stage, data) coordinates."""
    return {i: tuple(int(c) for c in coords)
            for i, coords in enumerate(np.ndindex(*topology.shape))}


def _instr_grouping(ins: CollectiveInstr, topology: Any) -> Optional[Grouping]:
    if ins.replica_groups is None:
        return None
    if ins.replica_groups == ():  # no groups: all positions together
        return _normalize([list(range(topology.num_devices))])
    return _normalize(ins.replica_groups)


def check_collective_axes(
    instrs: Sequence[CollectiveInstr],
    topology: Any,
    name: str = "collective_axes",
) -> CheckResult:
    """Every collective runs over a topology-declared axis grouping.

    Reductions must match the grouping of exactly one declared axis subset;
    permutes must move along the stage axis only. Singleton groups
    (degenerate axes) are accepted."""
    groupings = declared_groupings(topology)
    coords = _device_coords(topology)
    stage_dim = topology.axis_names.index("stage")
    bad: List[str] = []
    matched: Dict[str, List[str]] = {}
    for ins in instrs:
        if ins.op == "collective-permute":
            for s, t in ins.source_target_pairs or ():
                cs, ct = coords.get(s), coords.get(t)
                if cs is None or ct is None:
                    bad.append(f"permute pair ({s},{t}) outside device grid")
                    continue
                moved = [i for i in range(len(cs)) if cs[i] != ct[i]]
                if moved != [stage_dim]:
                    bad.append(f"permute pair ({s},{t}) moves along dims {moved}, "
                               f"expected stage (dim {stage_dim}) only: {ins.line[:120]}")
            matched.setdefault(ins.op, []).append("stage-neighbour")
            continue
        grouping = _instr_grouping(ins, topology)
        if grouping is None:
            continue
        if all(len(g) == 1 for g in grouping):
            matched.setdefault(ins.op, []).append("singleton")
            continue
        hits = [axes for axes, g in groupings.items() if g == grouping]
        if not hits:
            bad.append(f"{ins.op} over undeclared replica groups "
                       f"{sorted(tuple(sorted(g)) for g in grouping)}: {ins.line[:120]}")
        else:
            matched.setdefault(ins.op, []).append("+".join(hits[0]))
    return CheckResult(name, not bad, "; ".join(bad[:4]),
                       {"matched": matched, "violations": len(bad)})


# ---------------------------------------------------------------------------
# Donation: the step writes its state in place
# ---------------------------------------------------------------------------


def storage_ptrs(state: Any) -> Dict[str, int]:
    """``{path: storage address}`` of every tensor of an engine state's
    parameters (``params/...``), optimizer state (``opt/...``) and data FIFO
    (``fifo/...``)."""
    out = {}
    for prefix, tree in (("params", state.params), ("opt", state.opt_state),
                         ("fifo", state.data_fifo or ())):
        for path, t in state_leaves(tree, prefix).items():
            out[path] = t.untyped_storage().data_ptr()
    return out


def check_donation(
    before: Mapping[str, int],
    after: Mapping[str, int],
    name: str = "donation",
) -> CheckResult:
    """Every parameter and optimizer-state tensor of a donated step kept its
    storage (``storage_ptrs`` before and after the step), so donation can
    never silently regress to copying. The data FIFO's entries
    (``fifo/...``) are new each step: reported, not required, as the
    reference reports its queue leaves."""
    expected = [p for p in before if not p.startswith("fifo/")]
    queue = [p for p in before if p.startswith("fifo/")]
    missing = [p for p in expected if after.get(p) != before[p]]
    detail = "" if not missing else (
        f"{len(missing)}/{len(expected)} donated tensors not written in place "
        f"(first: {missing[:8]}); was the step built with donate=False?")
    return CheckResult(name, not missing, detail, {
        "expected": len(expected),
        "aliased": len(expected) - len(missing),
        "missing": missing[:32],
        "queue_leaves": len(queue),
        "queue_aliased": sum(1 for p in queue if after.get(p) == before[p]),
    })


def _data_all_reduce_count(instrs: Sequence[CollectiveInstr], topology: Any) -> int:
    """All-reduces grouped exactly over the topology's data axes (only
    groupings that communicate: a 1-data-shard topology's singletons do not
    count)."""
    want = _normalize(topology.replica_groups(topology.data_axes))
    if not any(len(g) > 1 for g in want):
        return 0
    return sum(1 for ins in instrs
               if ins.op == "all-reduce" and _instr_grouping(ins, topology) == want)


def check_data_reduction(
    instrs: Sequence[CollectiveInstr],
    topology: Any,
    name: str = "data_reduction",
    deferred: bool = False,
) -> CheckResult:
    """The data-axes gradient all-reduce is present iff the topology splits
    the data: over ``("pod", "data")`` on multi-pod shapes.

    ``deferred=True`` audits an asynchronous-data step, whose reduction was
    moved off the step into the deferred reduction: the step's data
    all-reduce must then be absent whatever the data shards (pair with
    ``check_async_step_reduction`` to prove the deferred one carries it)."""
    present = _data_all_reduce_count(instrs, topology) > 0
    need = (not deferred) and topology.data_shards > 1
    ok = present == need
    detail = "" if ok else (
        f"all-reduce over data axes {topology.data_axes} "
        f"{'missing' if need else 'present'} on topology "
        f"{topology.describe()} with {topology.data_shards} data shard(s)"
        + (" (deferred/async data mode)" if deferred else ""))
    return CheckResult(name, ok, detail,
                       {"present": present, "required": need, "deferred": deferred,
                        "data_axes": list(topology.data_axes)})


def check_async_step_reduction(
    step_instrs: Sequence[CollectiveInstr],
    reduce_instrs: Sequence[CollectiveInstr],
    topology: Any,
    name: str = "async_data_reduction",
) -> CheckResult:
    """The asynchronous data axis, over the step and the deferred reduction:
    the step waits on NO all-reduce grouped over the data axes, and the
    deferred reduction holds AT LEAST ONE (it moved, it was not lost). On a
    1-data-shard topology only the absence half applies."""
    in_step = _data_all_reduce_count(step_instrs, topology)
    in_reduce = _data_all_reduce_count(reduce_instrs, topology)
    need_reduce = topology.data_shards > 1
    bad: List[str] = []
    if in_step:
        bad.append(f"{in_step} data-axes all-reduce(s) on the async step critical "
                   f"path (axes {topology.data_axes})")
    if need_reduce and not in_reduce:
        bad.append(f"deferred reduce program has no all-reduce over data axes "
                   f"{topology.data_axes} — the gradient reduction was lost, not deferred")
    return CheckResult(name, not bad, "; ".join(bad),
                       {"in_step": in_step, "in_reduce": in_reduce,
                        "required_in_reduce": need_reduce,
                        "data_axes": list(topology.data_axes)})
