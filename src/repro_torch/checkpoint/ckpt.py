"""Pytree checkpointing: .npz arrays + JSON manifest of the tree structure.
Port of ``repro/checkpoint/ckpt.py``, in the reference's on-disk format: a
checkpoint that either package writes loads in the other.

A tree is nested dicts / lists / tuples / None with numpy leaves (the
engines convert their tensors with ``repro_torch.checkpoint.convert``).
Leaves are numbered in ``jax.tree_util.tree_flatten`` order: dict keys
sorted, sequence items by index, ``None`` dropped from the leaves but kept in
the manifest's ``spec`` as ``{"__kind__": "none"}``.

Two formats behind the same ``load_checkpoint``:

* **gathered** (``save_checkpoint``): one arrays file holding every leaf.
* **sharded** (``save_sharded_checkpoint``): one arrays file per pipeline
  stage shard. Each leaf with a shard axis is sliced along it across the
  shard files; the others live in shard 0 only. The manifest records the
  per-leaf axes, so loading reassembles the whole tree. Torch tensors carry
  no sharding to read, so the caller names the axes (``shard_axes``).

Both share the atomic-save discipline: every arrays file is written under a
temp name and ``os.replace``d into a step-versioned name, and the manifest,
swapped in last, is the single commit point. A crash anywhere mid-save
leaves the previous manifest naming the previous, complete file set.

The sharded save is split so that checkpoints can be written off the
training thread: ``snapshot_sharded`` (host slices, on the loop thread) and
``write_sharded_checkpoint`` (file I/O, safe on a background writer). In a
multi-process run every process saves at the same step: each slices and
writes only the shards it owns (``owned_shards``, from
``Topology.shard_owners``), one process writes the manifest, and three named
barriers order the generation scan, the shard writes and the manifest
commit; each process collects only its own superseded files.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

_SHARD_FILE_RE = re.compile(
    r"^arrays-\d{8}-shard(\d{5})-of-\d{5}(?:-g\d+)?\.npz$"
)
_SHARD_TMP_RE = re.compile(r"^\.arrays\.shard(\d{5})\.tmp\.npz$")


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_flatten`` order; ``None`` is no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for c in tree for x in tree_leaves(c)]
    return [tree]


def map_leaves(tree: Any, fn) -> Any:
    """``tree`` with each leaf replaced by ``fn(i, leaf)``, i its index in
    ``tree_leaves`` order; the structure (dicts, lists, tuples, None) kept."""
    count = [0]

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            out = [walk(c) for c in node]
            return out if isinstance(node, list) else tuple(out)
        i, count[0] = count[0], count[0] + 1
        return fn(i, node)

    return walk(tree)


def _spec(tree: Any) -> Any:
    if tree is None:
        return {"__kind__": "none"}
    if isinstance(tree, dict):
        return {
            "__kind__": "dict",
            "keys": sorted(tree.keys()),
            "children": {k: _spec(tree[k]) for k in sorted(tree.keys())},
        }
    if isinstance(tree, (list, tuple)):
        return {
            "__kind__": "list" if isinstance(tree, list) else "tuple",
            "children": [_spec(x) for x in tree],
        }
    return {"__kind__": "leaf"}


def save_checkpoint(path: str, tree: Any, step: int = 0, meta: Dict | None = None) -> None:
    """Gathered save. The arrays go to a step-versioned file (written under a
    temp name, then ``os.replace``d) and the manifest, swapped in last,
    names that file; the superseded files are collected only after it lands.
    (The temp name ends in .npz: ``np.savez`` appends the extension to
    anything else.)"""
    os.makedirs(path, exist_ok=True)
    leaves = tree_leaves(tree)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    arrays_name = f"arrays-{step:08d}.npz"
    arrays_tmp = os.path.join(path, ".arrays.tmp.npz")
    manifest_tmp = os.path.join(path, ".manifest.tmp.json")
    np.savez(arrays_tmp, **arrays)
    manifest = {"spec": _spec(tree), "num_leaves": len(leaves), "step": step,
                "arrays_file": arrays_name, "meta": meta or {}}
    with open(manifest_tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(arrays_tmp, os.path.join(path, arrays_name))
    os.replace(manifest_tmp, os.path.join(path, "manifest.json"))
    _gc_array_files(path, keep={arrays_name})


def _gc_array_files(path: str, keep: set, owned_shards: Optional[Set[int]] = None) -> None:
    """Drop array files superseded by a just-committed manifest (both the
    gathered and the sharded naming schemes), plus temp files stranded by
    an interrupted earlier save.

    ``owned_shards`` restricts a process of a multi-process run to the shard
    files (and shard temp files) it owns, so that processes never race on
    each other's files; only the owner of shard 0 also collects
    gathered-format leftovers. None: every file is this process's."""
    for name in os.listdir(path):
        if name in keep:
            continue
        m = _SHARD_FILE_RE.match(name) or _SHARD_TMP_RE.match(name)
        if m is not None:
            if owned_shards is not None and int(m.group(1)) not in owned_shards:
                continue
        else:
            gathered_stale = (name == "arrays.npz"
                              or (name.startswith("arrays-") and name.endswith(".npz"))
                              or (name.startswith(".arrays") and name.endswith(".tmp.npz")))
            if not gathered_stale or owned_shards is not None and 0 not in owned_shards:
                continue
        try:
            os.remove(os.path.join(path, name))
        except OSError:  # pragma: no cover — another writer raced us
            pass


# ---------------------------------------------------------------------------
# Stage-sharded format
# ---------------------------------------------------------------------------


def _shard_file_name(step: int, shard: int, num_shards: int, gen: int = 0) -> str:
    suffix = f"-g{gen}" if gen else ""
    return f"arrays-{step:08d}-shard{shard:05d}-of-{num_shards:05d}{suffix}.npz"


@dataclass
class ShardedSnapshot:
    """Host image of a sharded checkpoint: for each owned shard, ``{"leaf_i":
    array}``. Built on the training thread from host copies that the next
    step cannot touch; written by ``write_sharded_checkpoint``."""

    spec: Any
    num_leaves: int
    num_shards: int
    shard_axes: List[Optional[int]]
    # shard id -> {"leaf_i": host array}; only the owned shards are present
    arrays: Dict[int, Dict[str, np.ndarray]]
    owned: Set[int]


def snapshot_sharded(
    tree: Any, num_shards: int, shard_axes: Sequence[Optional[int]],
    owned_shards: Optional[Sequence[int]] = None,
    held_shards: Optional[Tuple[int, int]] = None,
) -> ShardedSnapshot:
    """Slice ``tree`` into a ``ShardedSnapshot`` (no file I/O).

    Shard s holds, for every leaf with a shard axis, slice s of
    ``num_shards`` along that axis (stage-stacked parameters and their
    optimizer state on axis 0, the stage delay queues on axis 1); shard 0
    also holds the leaves without one (shared parameters). ``shard_axes``
    is per leaf, in ``tree_leaves`` order, ints or None.

    ``owned_shards`` (default: all) are the shards this process writes.
    ``held_shards = (lo, hi)`` says that the tree's shard axes hold only
    shards ``[lo, hi)`` (a process's stage slab; default: all of them);
    every owned shard must lie in it."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    lo, hi = held_shards if held_shards is not None else (0, num_shards)
    if not 0 <= lo < hi <= num_shards:
        raise ValueError(f"held shards [{lo}, {hi}) outside [0, {num_shards})")
    owned = set(range(num_shards)) if owned_shards is None else set(owned_shards)
    if not owned <= set(range(lo, hi)):
        raise ValueError(f"owned shards {sorted(owned)} are not all held ([{lo}, {hi}))")
    leaves = [np.asarray(x) for x in tree_leaves(tree)]
    shard_axes = list(shard_axes)
    if len(shard_axes) != len(leaves):
        raise ValueError(f"{len(shard_axes)} shard axes for {len(leaves)} leaves")
    for i, (leaf, ax) in enumerate(zip(leaves, shard_axes)):
        if ax is not None and (ax >= leaf.ndim or leaf.shape[ax] % (hi - lo) != 0):
            raise ValueError(
                f"leaf {i}: axis {ax} of shape {leaf.shape} is not divisible "
                f"into {hi - lo} shards"
            )
    arrays: Dict[int, Dict[str, np.ndarray]] = {}
    for s in sorted(owned):
        shard = {}
        for i, (leaf, ax) in enumerate(zip(leaves, shard_axes)):
            if ax is None:
                if s == 0:
                    shard[f"leaf_{i}"] = leaf
            else:
                width = leaf.shape[ax] // (hi - lo)
                sl = [slice(None)] * leaf.ndim
                sl[ax] = slice((s - lo) * width, (s - lo + 1) * width)
                shard[f"leaf_{i}"] = leaf[tuple(sl)]
        arrays[s] = shard
    return ShardedSnapshot(spec=_spec(tree), num_leaves=len(leaves), num_shards=num_shards,
                           shard_axes=shard_axes, arrays=arrays, owned=owned)


def write_sharded_checkpoint(
    path: str, snapshot: ShardedSnapshot, step: int = 0, meta: Dict | None = None,
    write_manifest: bool = True, barrier: Optional[Callable[[str], None]] = None,
) -> None:
    """Commit a ``ShardedSnapshot`` to disk; pure host file I/O.

    A step saved before (a re-run into an old directory, the loop's
    final-step double save) is never overwritten in place: the save picks
    the next generation suffix, so a crash mid-save cannot leave the old
    manifest naming a mixed old/new shard set. The superseded files are
    collected after the manifest commit.

    Multi-process: every process calls this at the same step with its own
    snapshot (the owned shards partition ``range(num_shards)``), exactly one
    passes ``write_manifest=True``, and ``barrier`` is the rendezvous by
    name (``launch.distributed.barrier``). The barriers
    ``ckpt-{step}-g{gen}-named``, ``-shards`` and ``-commit`` come after the
    generation scan (every process names the same files before any
    writes), after the shard writes (the manifest never names a file not on
    disk) and after the manifest (no process collects a file it still
    names). Asynchronous writers must keep the submission order, one writer
    a process, so that the barriers stay in one global order."""
    os.makedirs(path, exist_ok=True)
    num_shards = snapshot.num_shards
    gen = 0
    while any(
        os.path.exists(os.path.join(path, _shard_file_name(step, s, num_shards, gen)))
        for s in range(num_shards)
    ):
        gen += 1
    shard_files = [_shard_file_name(step, s, num_shards, gen) for s in range(num_shards)]
    if barrier is not None:
        barrier(f"ckpt-{step}-g{gen}-named")
    for s in sorted(snapshot.owned):
        tmp = os.path.join(path, f".arrays.shard{s:05d}.tmp.npz")
        np.savez(tmp, **snapshot.arrays[s])
        os.replace(tmp, os.path.join(path, shard_files[s]))
    if barrier is not None:
        barrier(f"ckpt-{step}-g{gen}-shards")
    if write_manifest:
        manifest = {
            "format": "sharded",
            "spec": snapshot.spec,
            "num_leaves": snapshot.num_leaves,
            "num_shards": num_shards,
            "shard_axes": snapshot.shard_axes,
            "shard_files": shard_files,
            "step": step,
            "meta": meta or {},
        }
        manifest_tmp = os.path.join(path, ".manifest.tmp.json")
        with open(manifest_tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(manifest_tmp, os.path.join(path, "manifest.json"))
    if barrier is not None:
        barrier(f"ckpt-{step}-g{gen}-commit")
    all_owned = snapshot.owned == set(range(num_shards))
    _gc_array_files(path, keep=set(shard_files),
                    owned_shards=None if all_owned else snapshot.owned)


def save_sharded_checkpoint(
    path: str,
    tree: Any,
    num_shards: int,
    shard_axes: Sequence[Optional[int]],
    step: int = 0,
    meta: Dict | None = None,
    owned_shards: Optional[Sequence[int]] = None,
    write_manifest: bool = True,
    barrier: Optional[Callable[[str], None]] = None,
) -> None:
    """``snapshot_sharded`` followed at once by ``write_sharded_checkpoint``."""
    write_sharded_checkpoint(
        path, snapshot_sharded(tree, num_shards, shard_axes, owned_shards=owned_shards),
        step=step, meta=meta, write_manifest=write_manifest, barrier=barrier)


def _load_sharded_leaves(path: str, manifest: Dict) -> list:
    shards = [np.load(os.path.join(path, f)) for f in manifest["shard_files"]]
    leaves = []
    for i in range(manifest["num_leaves"]):
        ax = manifest["shard_axes"][i]
        key = f"leaf_{i}"
        if ax is None:
            leaves.append(shards[0][key])
        else:
            leaves.append(np.concatenate([sh[key] for sh in shards], axis=int(ax)))
    return leaves


def _rebuild(spec: Any, leaves: list, pos: list) -> Any:
    kind = spec["__kind__"]
    if kind == "none":
        return None
    if kind == "leaf":
        x = leaves[pos[0]]
        pos[0] += 1
        return x
    if kind == "dict":
        return {k: _rebuild(spec["children"][k], leaves, pos) for k in spec["keys"]}
    children = [_rebuild(c, leaves, pos) for c in spec["children"]]
    return children if kind == "list" else tuple(children)


def load_checkpoint(path: str) -> Tuple[Any, int, Dict]:
    """Load either format: (the whole tree with numpy leaves, step, meta)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") == "sharded":
        leaves = _load_sharded_leaves(path, manifest)
    else:
        # checkpoints from before the atomic save used a fixed "arrays.npz"
        data = np.load(os.path.join(path, manifest.get("arrays_file", "arrays.npz")))
        leaves = [data[f"leaf_{i}"] for i in range(manifest["num_leaves"])]
    tree = _rebuild(manifest["spec"], leaves, [0])
    return tree, manifest["step"], manifest.get("meta", {})
