"""Step recorder and named structural checks. Port of
``repro/analysis/jaxpr.py``.

The paper's correctness story is structural: per-stage delay FIFOs of exact
depth, O(stages) live activations under 1F1B, vocab-sized matmuls on the
last stage only, float32 state everywhere. None of these shows in a loss
curve until it has silently rotted, so they are checked on the step itself
before any numbers run.

The reference walks a jaxpr with the stack of enclosing primitives
(``"scan" in ctx``: a tick body; ``"cond" in ctx``: the last stage's
branch). PyTorch runs eagerly, so the port records one step as it runs:
``record_step`` runs it under a ``TorchDispatchMode`` that keeps every
operation's name, output shapes and dtypes and the scope it ran in. The
scopes come from the tick marker of ``engine/schedules.py``
(``TICK_HOOK``): a ``TickScope`` gives the tick, the stage, its
``"forward"`` or ``"backward"`` work, and whether the stage is the last
(K-1); ``"handoff"`` scopes hand a tick's tensors on; an operation outside
the tick loops has no scope. Calls of the flash-attention autograd Function
(B1 forward, B2/B3 backward) are counted through ``kernels/flash.py``'s
``CALL_HOOK``, the same on the CPU (plain versions) as on the card
(kernels), a backward in the scope of the forward it differentiates
(fill-drain runs its backward after the ticks, where the reference runs a
transposed scan). On the card the recorder also reads the kernels' launch
counters at each scope change. With ``track_memory`` it keeps the live
float bytes as ``launch.dryrun.StepTrace`` reckons them (storages followed
through weakref finalizers; the step's arguments not counted), with their
peak, which works on the meta device.

Named checks, each a ``CheckResult`` with the evidence it measured:

* ``scan_body_constant_in_microbatches``: each stage's forward and
  backward work of a tick runs the same operations for every microbatch
  count M, and the peak of live float bytes is constant in M (1F1B) or
  grows with it (fill-drain);
* ``no_dot_outside_cond``: a matmul with a vocab-sized float output runs in
  no tick scope of a stage other than K-1 (after the tick loop, where
  fill-drain's head runs, is allowed);
* ``stash_bound``: no float buffer stacked over the activation shape has
  more than 2K-1 slots, and the 2K-1 stash is present;
* ``kernel_in_scan`` (``check_pallas_in_scan``, the reference's name): B1
  and B2/B3 run inside tick scopes, at least once each per attention site;
* the dtype policy stays in ``analysis.dtype``; this recorder collects the
  float dtypes it checks.

Checks never assert: they return pass or fail with the evidence, so the
runner aggregates one JSON report and the tests check one property at a
time. The reference's ``as_jaxpr`` and ``sub_jaxprs`` unwrap nested jaxprs;
a recorded step is flat, with scopes, and has no counterpart for them.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.dtype import CheckResult
from repro_torch.launch.dryrun import StepTrace

Tensor = torch.Tensor

# matmul-like operations as the dispatch mode sees them (``F.linear`` and
# ``torch.matmul`` reach it decomposed into these)
DOT_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "linear", "matmul"})
# launch counters billed to the scope of the flash-attention call that made
# them (a backward's: its forward's tick); the others to the scope they ran in
FLASH_COUNTERS = frozenset({"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_bf16",
                            "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"})


class TickScope(NamedTuple):
    """Where an operation ran: tick ``t``, ``stage`` (None in a handoff),
    ``phase`` (``"forward"``, ``"backward"`` or ``"handoff"``) and whether
    the stage is the last, K-1."""

    tick: int
    stage: Optional[int]
    phase: str
    last: bool


@dataclass
class OpRecord:
    """One dispatched operation: its name (``aten.mm``'s ``"mm"``), its
    tensor outputs' shapes and dtype names, and its scope."""

    name: str
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    scope: Optional[TickScope]


@dataclass
class StepRecord:
    """What ``record_step`` saw of one step."""

    ops: List[OpRecord] = field(default_factory=list)
    # flash-attention Function calls: (phase, scope of the forward)
    flash_calls: List[Tuple[str, Optional[TickScope]]] = field(default_factory=list)
    # kernel -> launches in tick scopes ("in_ticks") and outside ("outside")
    launches: Dict[str, Dict[str, int]] = field(default_factory=dict)
    ticks: int = 0
    peak_float_bytes: Optional[int] = None

    @property
    def float_dtypes(self) -> Dict[str, int]:
        return float_dtypes(self)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _is_float(dtype: str) -> bool:
    dt = getattr(torch, dtype, None)
    return isinstance(dt, torch.dtype) and dt.is_floating_point


def kernel_launch_counts() -> Dict[str, int]:
    """The launch counters of B1-B5's wrappers (both entry points of B1-B3)."""
    from repro_torch.kernels import adam_step, flash, matmul

    out = {}
    for name, fn in (("flash_fwd", flash.flash_fwd), ("flash_bwd_dq", flash.flash_bwd_dq),
                     ("flash_bwd_dkv", flash.flash_bwd_dkv)):
        out[name] = fn.launches
        out[name + "_bf16"] = fn.launches_bf16
    out["matmul"] = matmul.matmul.launches
    out["adam_scale"] = adam_step.adam_scale.launches
    return out


class _Recorder(StepTrace):
    """The dispatch mode of ``record_step``: ``StepTrace``'s live-byte
    reckoning over float storages, plus the op log and the scopes."""

    def __init__(self, held: Sequence[Tensor], track_memory: bool,
                 counters: Optional[Callable[[], Dict[str, int]]]):
        super().__init__(held, count=False)
        self.track_memory = track_memory
        self.record = StepRecord()
        self.scope: Optional[TickScope] = None
        self.counters = counters
        # the scopes the launches since the last event belong to: the last
        # flash call's, and the one the step was in
        self._call: Optional[TickScope] = None
        self._ran_in: Optional[TickScope] = None
        self._last = counters() if counters else {}

    # -- scopes and launches --------------------------------------------------

    def _settle(self, call_scope: Optional[TickScope]) -> None:
        """Bill the launches since the last event to their scopes."""
        if self.counters is not None:
            now = self.counters()
            for k, n in now.items():
                d = n - self._last.get(k, 0)
                if d:
                    s = self._call if k in FLASH_COUNTERS else self._ran_in
                    where = "in_ticks" if s is not None and s.stage is not None else "outside"
                    row = self.record.launches.setdefault(k, {"in_ticks": 0, "outside": 0})
                    row[where] += d
            self._last = now
        self._call, self._ran_in = call_scope, self.scope

    def tick(self, t: Optional[int], stage: Optional[int], num_stages: int,
             phase: Optional[str]) -> None:
        if t is None:
            self.scope = None
        else:
            if self.scope is None or self.scope.tick != t:
                self.record.ticks += 1
            self.scope = TickScope(t, stage, phase, stage == num_stages - 1)
        self._settle(self.scope)

    def flash_call(self, ctx: Any, phase: str) -> None:
        if phase == "forward":
            ctx.analysis_scope = self.scope
        scope = getattr(ctx, "analysis_scope", None)
        self.record.flash_calls.append((phase, scope))
        self._settle(scope)

    def finish(self) -> None:
        self._settle(None)
        if self.track_memory:
            self.record.peak_float_bytes = self.peak

    # -- dispatch -------------------------------------------------------------

    def _track(self, t: Tensor) -> int:
        if not self.track_memory or not t.is_floating_point():
            return 0
        return super()._track(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, Tensor)]
        for t in outs:
            self._track(t)
        self.record.ops.append(OpRecord(
            func._overloadpacket.__name__, tuple(tuple(t.shape) for t in outs),
            tuple(_dtype_name(t.dtype) for t in outs), self.scope))
        return out


def record_step(fn: Callable, *args, held: Any = (), track_memory: bool = False,
                counters: Optional[Callable[[], Dict[str, int]]] = None,
                **kwargs) -> Tuple[Any, StepRecord]:
    """``fn(*args, **kwargs)`` and the ``StepRecord`` of the call: every
    operation (its backward passes included) with its tick scope, the
    flash-attention Function calls, and with ``counters`` (e.g.
    ``kernel_launch_counts``) the launches billed to tick scopes or outside.
    ``track_memory`` keeps the peak of live float bytes allocated beside
    ``held``'s storages (the step's arguments)."""
    from repro_torch.engine import schedules
    from repro_torch.kernels import flash

    held_list = [t for t in tree_leaves(held) if isinstance(t, Tensor)]
    rec = _Recorder(held_list, track_memory, counters)
    if schedules.TICK_HOOK is not None or flash.CALL_HOOK is not None:
        raise RuntimeError("record_step does not nest: a step is already being recorded")
    schedules.TICK_HOOK, flash.CALL_HOOK = rec.tick, rec.flash_call
    try:
        with rec:
            out = fn(*args, **kwargs)
        rec.finish()
    finally:
        schedules.TICK_HOOK, flash.CALL_HOOK = None, None
    return out, rec.record


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------


def iter_eqns(record: StepRecord) -> Iterator[Tuple[OpRecord, Optional[TickScope]]]:
    """``(op, scope)`` for every recorded operation, in order (the
    reference's ``iter_eqns``; a scope of None is outside the tick loops)."""
    for op in record.ops:
        yield op, op.scope


def n_eqns(record: StepRecord) -> int:
    """Operations the step ran."""
    return len(record.ops)


def iter_avals(record: StepRecord) -> Iterator[Tuple[Tuple[int, ...], str, OpRecord]]:
    """``(shape, dtype name, op)`` for every tensor an operation returned."""
    for op in record.ops:
        for shape, dt in zip(op.shapes, op.dtypes):
            yield shape, dt, op


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def max_float_bytes(record: StepRecord) -> int:
    """Largest float tensor any operation returned."""
    return max((_numel(s) * getattr(torch, dt).itemsize for s, dt, _ in iter_avals(record)
                if _is_float(dt)), default=0)


def float_dtypes(record: StepRecord) -> Dict[str, int]:
    """Histogram of the float dtypes of every operation's outputs (what
    ``analysis.dtype.check_dtype_policy`` reads)."""
    return dict(Counter(dt for _, dt, _ in iter_avals(record) if _is_float(dt)))


def tick_body_ops(record: StepRecord) -> Dict[str, List[int]]:
    """``"stage/phase"`` -> the distinct operation counts of that stage's
    forward or backward work over the step's ticks (one count each when the
    body is the same at every tick)."""
    per: Dict[Tuple[int, int, str], int] = Counter()
    for op in record.ops:
        s = op.scope
        if s is not None and s.stage is not None:
            per[(s.tick, s.stage, s.phase)] += 1
    bodies: Dict[str, set] = {}
    for (_t, k, phase), n in per.items():
        bodies.setdefault(f"{k}/{phase}", set()).add(n)
    return {key: sorted(v) for key, v in sorted(bodies.items())}


def vocab_dot_counts(record: StepRecord, vocab: int) -> Dict[str, int]:
    """Matmuls with a vocab-sized float output, forward and backward: in
    tick scopes of a stage other than K-1 (``"outside_cond"``: the
    reference's dot outside its ``lax.cond``), of stage K-1
    (``"inside_cond"``), and outside the tick loops (``"after_ticks"``)."""
    counts = {"outside_cond": 0, "inside_cond": 0, "after_ticks": 0}
    for op in record.ops:
        if op.name not in DOT_OPS:
            continue
        if not any(s and s[-1] == vocab and _is_float(dt) for s, dt in zip(op.shapes, op.dtypes)):
            continue
        s = op.scope
        if s is None or s.stage is None:
            counts["after_ticks"] += 1
        else:
            counts["inside_cond" if s.last else "outside_cond"] += 1
    return counts


def leading_dims_of(record: StepRecord, trailing_shape: Sequence[int]) -> List[int]:
    """Leading dims of every float tensor shaped ``(q, *trailing_shape)``:
    the slot counts of stacked activation buffers (the 1F1B input stash)."""
    trail = tuple(trailing_shape)
    return [int(s[0]) for s, dt, _ in iter_avals(record)
            if _is_float(dt) and len(s) == len(trail) + 1 and tuple(s[1:]) == trail]


# ---------------------------------------------------------------------------
# Named checks
# ---------------------------------------------------------------------------


def check_scan_body_constant_in_microbatches(
    records_by_m: Mapping[int, StepRecord],
    expect_const_bytes: bool = True,
    name: str = "scan_body_constant_in_microbatches",
) -> CheckResult:
    """The tick bodies must not depend on the microbatch count M.

    Each stage's forward and backward work of a tick must run the same
    operations at every tick and for every M (``tick_body_ops``).
    ``expect_const_bytes=True`` (1F1B) also pins the peak of live float
    bytes, the O(K) stash property; ``False`` (fill-drain) demands that it
    grows with M instead, which proves the measurement sees schedule memory.
    The records need ``track_memory``."""
    ms = sorted(records_by_m)
    if len(ms) < 2:
        return CheckResult(name, False, f"need >= 2 microbatch counts, got {ms}")
    eqns = {m: tick_body_ops(records_by_m[m]) for m in ms}
    fbytes = {m: records_by_m[m].peak_float_bytes for m in ms}
    fixed = all(len(v) == 1 for m in ms for v in eqns[m].values())
    ok_eqns = fixed and bool(eqns[ms[0]]) and all(eqns[m] == eqns[ms[0]] for m in ms)
    if any(b is None for b in fbytes.values()):
        ok_bytes, want = False, "recorded (track_memory)"
    elif expect_const_bytes:
        ok_bytes, want = len(set(fbytes.values())) == 1, "constant"
    else:
        ok_bytes = all(fbytes[a] < fbytes[b] for a, b in zip(ms, ms[1:]))
        want = "growing"
    detail = "" if (ok_eqns and ok_bytes) else (
        f"tick bodies' operation counts {eqns} must be one count each and constant in M; "
        f"peak live float bytes {fbytes} must be {want} in M")
    return CheckResult(name, ok_eqns and ok_bytes, detail,
                       {"eqns": eqns, "max_float_bytes": fbytes})


def check_no_dot_outside_cond(
    record: StepRecord,
    vocab: int,
    require_gated: bool = True,
    name: str = "no_dot_outside_cond",
) -> CheckResult:
    """No vocab-sized matmul in the tick scope of a stage other than K-1.

    The O(vocab) head matmul (and its backward) must run only on the last
    stage; one on another stage makes every stage pay for the head every
    tick. ``require_gated=True`` (1F1B) also demands that the last stage's
    ticks run one: a check that finds none is measuring the wrong step."""
    counts = vocab_dot_counts(record, vocab)
    ok = counts["outside_cond"] == 0
    if require_gated:
        ok = ok and counts["inside_cond"] >= 1
    detail = "" if ok else (
        f"vocab({vocab})-sized matmuls by scope: {counts}; expected 0 in the ticks of "
        "stages other than K-1" + (" and >= 1 in stage K-1's" if require_gated else ""))
    return CheckResult(name, ok, detail, dict(counts))


def check_kernel_in_scan(
    record: StepRecord,
    sites: int = 1,
    name: str = "kernel_in_scan",
) -> CheckResult:
    """The flash-attention Function runs inside the tick scopes.

    Under ``use_kernels`` each attention site of a stage calls B1 forward
    and B2/B3 in its backward, and both must run in tick scopes at least
    ``sites`` times each (the attention layers): a call hoisted out of the
    ticks means the schedule stopped calling it per tick. Where the
    recorder read launch counters, every call in a tick scope on the card
    must also have launched its kernels there."""
    fwd_in = sum(1 for p, s in record.flash_calls if p == "forward" and s is not None)
    bwd_in = sum(1 for p, s in record.flash_calls if p == "backward" and s is not None)
    outside = sum(1 for _p, s in record.flash_calls if s is None)
    ok = fwd_in >= sites and bwd_in >= sites
    bad = []
    if not ok:
        bad.append(f"{fwd_in} forward and {bwd_in} backward flash-attention calls in tick "
                   f"scopes (need >= {sites} each); {outside} outside")
    launched = {k: v["in_ticks"] for k, v in record.launches.items()}
    if any(launched.get(k, 0) for k in ("flash_fwd", "flash_fwd_bf16")):
        want = {"flash_fwd": fwd_in, "flash_bwd_dq": bwd_in, "flash_bwd_dkv": bwd_in}
        for k, n in want.items():
            got = launched.get(k, 0) + launched.get(k + "_bf16", 0)
            if got != n:
                bad.append(f"{k}: {got} launches in tick scopes for {n} calls")
    return CheckResult(name, not bad, "; ".join(bad),
                       {"in_scan": fwd_in + bwd_in, "outside_scan": outside,
                        "forward_in_scan": fwd_in, "backward_in_scan": bwd_in,
                        "launches": {k: dict(v) for k, v in record.launches.items()},
                        "ticks": record.ticks})


# the reference's name for the same check
check_pallas_in_scan = check_kernel_in_scan


def check_stash_bound(
    record: StepRecord,
    num_stages: int,
    activation_shape: Sequence[int],
    name: str = "stash_bound",
) -> CheckResult:
    """The 1F1B input stash never exceeds its 2K-1 slots.

    Stage k re-reads its forward input 2(K-1-k) ticks later, so 2K-1 slots
    are necessary and sufficient; a wider stash silently brings back the
    O(M) memory the schedule exists to avoid. Every float buffer stacked
    over the activation shape ``(mb, S, d)`` must have <= 2K-1 slots, and
    the stash itself (exactly 2K-1) must be present."""
    bound = 2 * num_stages - 1
    dims = leading_dims_of(record, activation_shape)
    over = [d for d in dims if d > bound]
    ok = not over and bound in dims
    detail = "" if ok else (
        f"activation{tuple(activation_shape)} buffers with slot counts {sorted(set(dims))}; "
        f"bound 2K-1 = {bound}" + ("" if bound in dims else " (expected stash not found)"))
    return CheckResult(name, ok, detail, {"slot_counts": sorted(set(dims)), "bound": bound})
