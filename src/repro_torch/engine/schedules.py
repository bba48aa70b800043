"""Pipeline tick schedules for the SPMD engine. Port of
``repro/engine/schedules.py``.

Both schedules share one contract:

    grad_fn = make_schedule_grad(cfg, K, M, schedule=...)
    loss, (g_stacked, g_shared) = grad_fn(stacked, shared, batch)

with ``stacked`` the ``{path: (K, per, ...)}`` block leaves, ``shared`` the
embedding, position embedding, final norm and head, and ``batch`` tokens and
labels of shape (M, mb, S).

The reference runs the stages on the devices of a ``stage`` mesh axis inside
``shard_map`` and scans the tick body. On one card the port emulates that
in one process: the stages stay stacked on the leading axis, each tick loops
over the stages that have a microbatch, and ``ppermute`` becomes handing a
tensor to the neighbouring stage's receive slot. The reference runs idle
ticks on zeros, which contribute exactly zero; they are skipped here, which
changes no result and makes the work (and the kernel launches) per step
exact: M x (layers) stage-layer forwards for fill-drain, twice that for
1F1B, which recomputes in its backward.

* ``fill_drain``: M + K - 1 forward ticks under autograd, the last stage
  collecting every microbatch's output; then one backward of the mean
  cross-entropy over all microbatches. Activations held: O(M) per stage.
* ``1f1b``: forward F(k, m) at tick k + m, backward B(k, m) at tick
  2(K-1) - k + m (t = 0 .. M + 2K - 3). Forward ticks run without autograd
  and stash the stage input in a circular buffer of 2K - 1 slots; the
  backward recomputes from the stashed input and takes
  ``torch.autograd.grad`` against that stage's weight slices, accumulating
  into float32 gradient buffers. The last stage seeds its backward with
  ce_m / M from this tick's fresh output; stage 0's input gradient becomes
  the embedding gradient. Activations held: O(K) per stage, whatever M.

Each process runs the tick loop only for its slab of the stages ``[k0,
k1)`` (a ``StageSlab``); a single-process run is the slab ``(0, K)``. A
handoff to a stage of the same process is the copy into its receive slot; a
handoff across the slab's edge goes through the transport
(``launch.distributed.Transport``) at the tick boundary: the activation of
stage k1-1 forward to the next process, the gradient of stage k0's input
back to the previous one. 1F1B takes explicit per-stage gradients, so only
its sends and receives cross. Fill-drain's one backward through the whole
graph breaks at each boundary: the process that holds the last stage
differentiates the loss, and each process in reverse stage order
differentiates its boundary outputs with the gradients it receives and
sends back those of its received inputs. Each (stage, microbatch) runs
once on one process, so the launches of all processes sum to the
single-process counts.

``make_local_grad`` runs a process's data replicas one after another, each
the schedule above on its rows of every microbatch, and sums their losses
and gradients; the engine sums those over the processes and divides by the
replica count (``SpmdEngine._reduce``).

Under the ``bf16`` precision policy both schedules run on compute-dtype
copies of the float32 masters (``cast_params``) and return float32
gradients. Fill-drain casts each stage's weights at each use, so that
autograd sums the microbatches' gradients into the masters in float32, as
the reference's cast inside its stage function does. 1F1B casts once per
step: each tick's gradients are taken against those copies and added into
its float32 buffers, which is what the reference's per-tick cast gives.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import cast_params, cross_entropy, embed, head_logits
from repro_torch.models.transformer import stage_apply, template_block

Tensor = torch.Tensor
Params = Dict[str, Tensor]
GradFn = Callable[[Params, Params, Dict[str, Tensor]], Tuple[Tensor, Tuple[Params, Params]]]

SCHEDULES = ("fill_drain", "1f1b")

# The static analyzer's tick marker (``analysis.trace``): None unless an
# audit records a step, so that a tick pays one test of a module global.
# Called as ``TICK_HOOK(t, stage, num_stages, phase)`` when a stage starts
# its ``"forward"`` or ``"backward"`` work of tick t, as ``TICK_HOOK(t,
# None, num_stages, "handoff")`` when tick t hands its tensors on, and with
# t None when the tick loop ends.
TICK_HOOK: Optional[Callable[[Optional[int], Optional[int], int, Optional[str]], None]] = None

# Structural invariants each schedule promises (the reference's table, read
# by the static analyzer, ``analysis.runner``).
SCHEDULE_INVARIANTS = {
    "fill_drain": {
        "const_float_bytes_in_M": False,
        "vocab_dot_gated": False,
        "stash_bound": False,
    },
    "1f1b": {
        "const_float_bytes_in_M": True,
        "vocab_dot_gated": True,
        "stash_bound": True,
    },
}


@dataclass
class ScheduleStats:
    """What a schedule held between ticks in its last call, per stage."""

    held_bytes: int = 0  # activation bytes one stage keeps in its buffers across ticks
    stash_slots: int = 0  # slots in each stage's 1F1B input stash
    saved_bytes: List[int] = field(default_factory=list)  # live autograd-saved bytes after each tick

    def start(self) -> None:
        self.held_bytes, self.stash_slots, self.saved_bytes = 0, 0, []


def stash_slots(num_stages: int) -> int:
    """Depth of the 1F1B input stash. Stage k re-reads its input 2(K-1-k)
    ticks after stashing it, at most 2(K-1) (stage 0), so 2K - 1 slots
    suffice and a slot is overwritten only after its reader is done."""
    return 2 * num_stages - 1


def seeds_from_head(stage: int, num_stages: int) -> bool:
    """Whether ``stage`` runs the vocab head on its fresh forward output
    and seeds its 1F1B backward from it: the last stage only, which the
    reference gates with ``lax.cond``."""
    return stage == num_stages - 1


def _leaves(params: Params) -> Params:
    """Gradient leaves that share storage with ``params``."""
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _accumulate(acc: Params, leaves: Params, grads) -> None:
    """acc[path] += grad for each leaf the graph reached."""
    for p, g in zip(leaves, grads):
        if g is not None:
            acc[p] += g


def _nbytes(*xs: Optional[Tensor]) -> int:
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


class _SavedBytes:
    """Counts the bytes that autograd holds saved for a backward: each saved
    tensor is wrapped while packed, and uncounted when its graph frees it."""

    class _Packed:
        __slots__ = ("t", "owner", "n")

        def __init__(self, t: Tensor, owner: "_SavedBytes"):
            self.t, self.owner, self.n = t, owner, _nbytes(t)
            owner.live += self.n

        def __del__(self):
            self.owner.live -= self.n

    def __init__(self, active: bool):
        self.live = 0
        self.active = active

    def hooks(self):
        if not self.active:
            return contextlib.nullcontext()
        return torch.autograd.graph.saved_tensors_hooks(
            lambda t: self._Packed(t, self), lambda p: p.t)


# ---------------------------------------------------------------------------
# the stages one process runs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StageSlab:
    """The stages ``[k0, k1)`` that this process runs, the processes that
    run stage k0 - 1 and stage k1 for the same data shards (None at the
    pipeline's ends) and the ``launch.distributed.Transport`` between them.
    A single-process run is the slab ``(0, K)``, with no neighbours and no
    transport."""

    k0: int
    k1: int
    prev_rank: Optional[int] = None
    next_rank: Optional[int] = None
    transport: object = None

    def exchange(self, sends, recvs) -> None:
        """The transport's exchange; nothing crosses a slab with no edges."""
        if sends or recvs:
            self.transport.exchange(sends, recvs)


def _zeros_for(leaves: Params, grads) -> Params:
    """Float32 gradients of ``leaves``; zeros where the graph did not reach."""
    return {p: (torch.zeros(w.shape, dtype=torch.float32, device=w.device) if g is None
                else g.float()) for (p, w), g in zip(leaves.items(), grads)}


# ---------------------------------------------------------------------------
# fill-drain: forward ticks under autograd, one backward
# ---------------------------------------------------------------------------


def _fill_drain_forward(cfg: ModelConfig, block, K: int, M: int, slab: StageSlab,
                        stacked: Params, shared: Params, batch: Dict[str, Tensor],
                        stats: Optional[ScheduleStats]):
    """Fill-drain's M + K - 1 forward ticks over the slab's stages, under
    autograd: ``(loss, outs, x_in)``. ``loss`` is the mean cross-entropy
    over all microbatches where the slab holds the last stage (else None),
    ``outs`` stage k1 - 1's output of each microbatch, ``x_in`` the inputs
    received for stage k0 by microbatch (leaves that require grad; none on
    the first stage)."""
    tokens, labels = batch["tokens"], batch["labels"]
    _, mb, S = tokens.shape
    k0, k1 = slab.k0, slab.k1
    first, last = k0 == 0, k1 == K
    saved = _SavedBytes(stats is not None)
    if stats is not None:
        stats.start()
    cdt = cfg.compute_dtype
    stage_w = [{p: w[j] for p, w in stacked.items()} for j in range(k1 - k0)]
    x_in: Dict[int, Tensor] = {}
    outs: List[Optional[Tensor]] = [None] * M
    loss = None
    with saved.hooks():
        sh = cast_params(shared, cdt)  # each used once: embedding and head
        emb = embed(sh, cfg, tokens) if first else None  # (M, mb, S, d): staged by stage 0
        recv: Dict[int, Tensor] = {}
        for t in range(M + K - 1):
            sent: Dict[int, Tensor] = {}
            for k in range(k0, k1):
                m = t - k
                if not 0 <= m < M:
                    continue  # bubble: the reference computes zeros here
                if TICK_HOOK is not None:
                    TICK_HOOK(t, k, K, "forward")
                x = (emb[m] if first else x_in[m]) if k == k0 else recv[k]
                h = stage_apply(block, cast_params(stage_w[k - k0], cdt), x)
                if k == k1 - 1:
                    outs[m] = h  # the slab's last stage collects microbatch m
                else:
                    sent[k + 1] = h  # ppermute to the next stage
            recv = sent
            if TICK_HOOK is not None:
                TICK_HOOK(t, None, K, "handoff")
            # the tick boundary: stage k1 - 1's output out, stage k0's next input in
            sends, recvs = [], []
            m_out, m_in = t - (k1 - 1), t + 1 - k0
            if not last and 0 <= m_out < M:
                sends.append((outs[m_out], slab.next_rank))
            if not first and 0 <= m_in < M:
                x_in[m_in] = torch.empty((mb, S, cfg.d_model), dtype=cdt, device=tokens.device)
                recvs.append((x_in[m_in], slab.prev_rank))
            slab.exchange(sends, recvs)
            if recvs:
                x_in[m_in].requires_grad_(True)
            if stats is not None:
                stats.saved_bytes.append(saved.live)
        if TICK_HOOK is not None:
            TICK_HOOK(None, None, K, None)
        if last:
            loss = cross_entropy(head_logits(sh, cfg, torch.stack(outs)), labels)
    if stats is not None:
        # staged embeddings and collected outputs (M each) plus a receive slot
        stats.held_bytes = _nbytes(emb) + (M + 1) * _nbytes(outs[0])
    return loss, outs, x_in


def make_fill_drain_loss(cfg: ModelConfig, num_stages: int, num_microbatches: int,
                         stats: Optional[ScheduleStats] = None):
    """``loss_fn(stacked, shared, batch) -> scalar``, differentiable in both:
    the forward ticks of one process that runs every stage."""
    K, M = num_stages, num_microbatches
    block, whole = template_block(cfg), StageSlab(0, num_stages)

    def loss_fn(stacked: Params, shared: Params, batch: Dict[str, Tensor]) -> Tensor:
        return _fill_drain_forward(cfg, block, K, M, whole, stacked, shared, batch, stats)[0]

    return loss_fn


def _fill_drain_grad(cfg: ModelConfig, K: int, M: int, slab: StageSlab,
                     stats: Optional[ScheduleStats]) -> GradFn:
    """Fill-drain's gradient over the slab: its forward ticks, then one
    backward. The process that holds the last stage differentiates the
    loss; the others wait for the gradients of their outputs from the next
    process. Each sends back those of its received inputs, so the
    backwards run in reverse stage order."""
    block = template_block(cfg)
    first, last = slab.k0 == 0, slab.k1 == K

    def grad_fn(stacked: Params, shared: Params, batch: Dict[str, Tensor]):
        sl, hl = _leaves(stacked), _leaves(shared)
        loss, outs, x_in = _fill_drain_forward(cfg, block, K, M, slab, sl, hl, batch, stats)
        wrt = [*sl.values(), *hl.values(), *(x_in[m] for m in range(M) if not first)]
        if last:
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
            loss = loss.detach()
        else:
            dy = [torch.empty_like(o) for o in outs]
            slab.exchange([], [(g, slab.next_rank) for g in dy])
            grads = torch.autograd.grad(outs, wrt, grad_outputs=dy, allow_unused=True)
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        n_s, n_h = len(sl), len(hl)
        if not first:
            slab.exchange([(g, slab.prev_rank) for g in grads[n_s + n_h:]], [])
        return loss, (_zeros_for(sl, grads[:n_s]), _zeros_for(hl, grads[n_s:n_s + n_h]))

    return grad_fn


# ---------------------------------------------------------------------------
# 1F1B: explicit forward / backward ticks, O(K) activation stash
# ---------------------------------------------------------------------------


def _1f1b_grad(cfg: ModelConfig, K: int, M: int, slab: StageSlab,
               stats: Optional[ScheduleStats]) -> GradFn:
    """1F1B's explicit-backward timetable over the slab's stages."""
    Q = stash_slots(K)
    block = template_block(cfg)
    k0, k1 = slab.k0, slab.k1
    n = k1 - k0

    def grad_fn(stacked: Params, shared: Params, batch: Dict[str, Tensor]):
        tokens, labels = batch["tokens"], batch["labels"]
        _, mb, S = tokens.shape
        dev, cdt = tokens.device, cfg.compute_dtype
        act = (mb, S, cfg.d_model)
        g_stage = {p: torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                   for p, w in stacked.items()}
        g_shared = {p: torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                    for p, w in shared.items()}
        # every tick below runs on these compute-dtype copies
        stacked, shared = cast_params(stacked, cdt), cast_params(shared, cdt)
        # slot j of each per-stage buffer belongs to stage k0 + j
        stash = [torch.zeros((Q,) + act, dtype=cdt, device=dev) for _ in range(n)]
        fwd_recv = [torch.zeros(act, dtype=cdt, device=dev) for _ in range(n)]
        bwd_recv = [torch.zeros(act, dtype=cdt, device=dev) for _ in range(n)]
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        saved = _SavedBytes(stats is not None)
        if stats is not None:
            stats.start()

        # each stage's work of a tick is a call, so that nothing it made
        # outlives it but what it hands on: the held bytes are the same at
        # every tick of the steady state, whatever M
        def forward(k: int, t: int, m: int, sent_f: Dict[int, Tensor], sends: list):
            """Stage k's forward of microbatch m, stashing its input and
            handing its output on; on the last stage (``seeds_from_head``)
            the vocab head's backward seed, ce_m / M's gradient."""
            j = k - k0
            with torch.no_grad():
                x_in = embed(shared, cfg, tokens[m]) if k == 0 else fwd_recv[j]
                stash[j][t % Q].copy_(x_in)
                h = stage_apply(block, {p: w[j] for p, w in stacked.items()}, x_in)
            if k + 1 < k1:
                sent_f[k + 1] = h  # ppermute to the next stage
            elif k < K - 1:
                sends.append((h, slab.next_rank))  # across the slab's edge
            if not seeds_from_head(k, K):
                return None
            with saved.hooks():
                sh = _leaves(shared)
                hh = h.detach().requires_grad_(True)
                ce = cross_entropy(head_logits(sh, cfg, hh), labels[m])
                dy, *dsh = torch.autograd.grad(
                    ce, [hh, *sh.values()], grad_outputs=torch.full_like(ce, 1.0 / M),
                    allow_unused=True)
            return dy, sh, dsh, ce.detach()

        def backward(k: int, t: int, m: int, seed, sent_b: Dict[int, Tensor],
                     sends: list) -> None:
            """Stage k's backward of microbatch m, recomputed from its
            stashed input, handing its input gradient back (stage 0's is the
            embedding's)."""
            j = k - k0
            with saved.hooks():
                if k == K - 1:
                    # the last stage seeds from this tick's fresh output
                    dy, sh, dsh, ce = seed
                    _accumulate(g_shared, sh, dsh)
                    loss.add_(ce / M)
                else:
                    dy = bwd_recv[j]
                wk = _leaves({p: w[j] for p, w in stacked.items()})
                x_saved = stash[j][(t - 2 * (K - 1 - k)) % Q].detach().requires_grad_(True)
                h_re = stage_apply(block, wk, x_saved)
                dx, *dw = torch.autograd.grad(h_re, [x_saved, *wk.values()], grad_outputs=dy)
                for p, g in zip(wk, dw):
                    g_stage[p][j] += g
                if k > k0:
                    sent_b[k - 1] = dx  # ppermute back to the previous stage
                elif k > 0:
                    sends.append((dx, slab.prev_rank))  # across the slab's edge
                else:
                    sh = _leaves(shared)
                    x0 = embed(sh, cfg, tokens[m])
                    _accumulate(g_shared, sh, torch.autograd.grad(
                        x0, list(sh.values()), grad_outputs=dx, allow_unused=True))

        for t in range(M + 2 * (K - 1)):
            sent_f: Dict[int, Tensor] = {}
            sent_b: Dict[int, Tensor] = {}
            sends = []
            for k in range(k0, k1):
                # forward: stage k runs microbatch t - k; backward: microbatch
                # t - (2(K-1) - k), on the last stage the same one, seeded
                # by its forward. The others run their backward first: the
                # two are independent (other microbatches, other stash
                # slots), and this way no forward output waits through a
                # backward, so a tick holds the same bytes whatever M
                m_f, m_b = t - k, t - (2 * (K - 1) - k)
                last = k == K - 1
                if not last and 0 <= m_b < M:
                    if TICK_HOOK is not None:
                        TICK_HOOK(t, k, K, "backward")
                    backward(k, t, m_b, None, sent_b, sends)
                seed = None
                if 0 <= m_f < M:
                    if TICK_HOOK is not None:
                        TICK_HOOK(t, k, K, "forward")
                    seed = forward(k, t, m_f, sent_f, sends)
                if last and 0 <= m_b < M:
                    if TICK_HOOK is not None:
                        TICK_HOOK(t, k, K, "backward")
                    backward(k, t, m_b, seed, sent_b, sends)
                seed = None
            if TICK_HOOK is not None:
                TICK_HOOK(t, None, K, "handoff")
            for k, x in sent_f.items():
                fwd_recv[k - k0].copy_(x)
            for k, x in sent_b.items():
                bwd_recv[k - k0].copy_(x)
            # what the neighbours sent this tick: stage k0's next input and
            # stage k1 - 1's next output gradient
            recvs = []
            if k0 > 0 and 0 <= t + 1 - k0 < M:
                recvs.append((fwd_recv[0], slab.prev_rank))
            if k1 < K and 0 <= t + 1 - (2 * (K - 1) - (k1 - 1)) < M:
                recvs.append((bwd_recv[n - 1], slab.next_rank))
            slab.exchange(sends, recvs)
            if stats is not None:
                stats.saved_bytes.append(saved.live)
        if TICK_HOOK is not None:
            TICK_HOOK(None, None, K, None)

        if stats is not None:
            stats.stash_slots = Q
            stats.held_bytes = _nbytes(stash[0], fwd_recv[0], bwd_recv[0])
        return loss, (g_stage, g_shared)

    return grad_fn


def make_1f1b_grad(cfg: ModelConfig, num_stages: int, num_microbatches: int,
                   stats: Optional[ScheduleStats] = None) -> GradFn:
    """``grad_fn(stacked, shared, batch) -> (loss, (g_stacked, g_shared))``
    with the explicit-backward 1F1B timetable, every stage in one process."""
    return _1f1b_grad(cfg, num_stages, num_microbatches, StageSlab(0, num_stages), stats)


# ---------------------------------------------------------------------------
# dispatch, data replicas, memory model
# ---------------------------------------------------------------------------


def make_schedule_grad(cfg: ModelConfig, num_stages: int, num_microbatches: int,
                       schedule: str = "fill_drain",
                       stats: Optional[ScheduleStats] = None,
                       slab: Optional[StageSlab] = None) -> GradFn:
    """``grad_fn(stacked, shared, batch) -> (loss, (g_stacked, g_shared))``
    over ``slab``'s stages (default: every stage, in one process).
    ``stacked`` holds the slab's stages ``(k1 - k0, per, ...)``, ``shared``
    every shared leaf. In a slab of several processes ``loss`` is the
    schedule's on the process that holds the last stage and zero elsewhere,
    and ``g_shared`` this process's part of the shared gradients (the
    embedding's on the first stage, the head's and final norm's on the
    last, zeros elsewhere): summed over the processes, they are the whole."""
    slab = slab if slab is not None else StageSlab(0, num_stages)
    if schedule == "fill_drain":
        return _fill_drain_grad(cfg, num_stages, num_microbatches, slab, stats)
    if schedule == "1f1b":
        return _1f1b_grad(cfg, num_stages, num_microbatches, slab, stats)
    raise ValueError(f"unknown pipeline schedule {schedule!r}; one of {SCHEDULES}")


def make_local_grad(grad_fn: GradFn, replicas: int):
    """``local_grad_fn(stacked, shared, batch) -> (loss, (g_stacked,
    g_shared))``: the sums over a process's ``replicas`` data replicas of
    their losses and local gradients. Replica i takes the i-th of
    ``replicas`` equal row blocks of every microbatch (over all processes,
    the reference's pod-major split of the flattened ``(pod, data)`` axes),
    and its loss and gradient are ``grad_fn``'s on those rows alone: the
    mean over its own tokens, as on the reference's data replica. The
    engine's ``_reduce`` sums them over the processes and divides by R."""

    def local_grad_fn(stacked: Params, shared: Params, batch: Dict[str, Tensor]):
        if replicas == 1:
            return grad_fn(stacked, shared, batch)
        w = batch["tokens"].shape[1] // replicas
        loss = gs = gsh = None
        for i in range(replicas):
            rows = {k: v[:, i * w:(i + 1) * w].contiguous() for k, v in batch.items()}
            l, (a, b) = grad_fn(stacked, shared, rows)
            if loss is None:
                loss, gs, gsh = l, a, b
                continue
            loss = loss + l
            for acc, d in ((gs, a), (gsh, b)):
                for k, g in d.items():
                    acc[k].add_(g)
            del a, b
        return loss, (gs, gsh)

    return local_grad_fn


def schedule_activation_bytes(cfg: ModelConfig, num_stages: int, num_microbatches: int,
                              microbatch_size: int, seq_len: int,
                              schedule: str = "fill_drain") -> int:
    """Activation bytes one stage holds across ticks: fill-drain keeps the
    staged embeddings and the collected outputs (M each) and a receive slot,
    (2M + 1) activations; 1F1B keeps its stash and two receive slots,
    (2K + 1) activations, whatever M."""
    act = (microbatch_size * seq_len * cfg.d_model
           * torch.empty((), dtype=cfg.compute_dtype).element_size())
    if schedule == "fill_drain":
        return (2 * num_microbatches + 1) * act
    if schedule == "1f1b":
        return (stash_slots(num_stages) + 2) * act
    raise ValueError(f"unknown pipeline schedule {schedule!r}; one of {SCHEDULES}")
