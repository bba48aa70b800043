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

``make_local_grad`` is the port's form of the reference's
``reduce_data=False``: each data replica's local gradient, with no
reduction over the replicas. On one card the replicas run one after
another, each the schedule above on its rows of every microbatch, and their
losses and gradients are stacked along a leading replica axis; the engine
reduces them (``SpmdEngine._reduce``).

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

# Structural invariants each schedule promises (the reference's table, read
# by its static analyzer; the port's tests check the first and the last).
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
# fill-drain: forward ticks under autograd, one backward
# ---------------------------------------------------------------------------


def make_fill_drain_loss(cfg: ModelConfig, num_stages: int, num_microbatches: int,
                         stats: Optional[ScheduleStats] = None):
    """``loss_fn(stacked, shared, batch) -> scalar``, differentiable in both."""
    K, M = num_stages, num_microbatches
    block = template_block(cfg)

    def loss_fn(stacked: Params, shared: Params, batch: Dict[str, Tensor]) -> Tensor:
        tokens, labels = batch["tokens"], batch["labels"]
        saved = _SavedBytes(stats is not None)
        if stats is not None:
            stats.start()
        cdt = cfg.compute_dtype
        stage_w = [{p: w[k] for p, w in stacked.items()} for k in range(K)]
        with saved.hooks():
            sh = cast_params(shared, cdt)  # each used once: embedding and head
            emb = embed(sh, cfg, tokens)  # (M, mb, S, d): staged by stage 0
            recv: Dict[int, Tensor] = {}
            outs: List[Optional[Tensor]] = [None] * M
            for t in range(M + K - 1):
                sent: Dict[int, Tensor] = {}
                for k in range(K):
                    m = t - k
                    if not 0 <= m < M:
                        continue  # bubble: the reference computes zeros here
                    h = stage_apply(block, cast_params(stage_w[k], cdt),
                                    emb[m] if k == 0 else recv[k])
                    if k == K - 1:
                        outs[m] = h  # the last stage collects microbatch m
                    else:
                        sent[k + 1] = h  # ppermute to the next stage
                recv = sent
                if stats is not None:
                    stats.saved_bytes.append(saved.live)
            x = torch.stack(outs)  # (M, mb, S, d)
            loss = cross_entropy(head_logits(sh, cfg, x), labels)
        if stats is not None:
            # staged embeddings and collected outputs (M each) plus a receive slot
            stats.held_bytes = _nbytes(emb) + _nbytes(x) + _nbytes(x[0])
        return loss

    return loss_fn


# ---------------------------------------------------------------------------
# 1F1B: explicit forward / backward ticks, O(K) activation stash
# ---------------------------------------------------------------------------


def make_1f1b_grad(cfg: ModelConfig, num_stages: int, num_microbatches: int,
                   stats: Optional[ScheduleStats] = None) -> GradFn:
    """``grad_fn(stacked, shared, batch) -> (loss, (g_stacked, g_shared))``
    with the explicit-backward 1F1B timetable."""
    K, M = num_stages, num_microbatches
    Q = stash_slots(K)
    block = template_block(cfg)

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
        stash = [torch.zeros((Q,) + act, dtype=cdt, device=dev) for _ in range(K)]
        fwd_recv = [torch.zeros(act, dtype=cdt, device=dev) for _ in range(K)]
        bwd_recv = [torch.zeros(act, dtype=cdt, device=dev) for _ in range(K)]
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        saved = _SavedBytes(stats is not None)
        if stats is not None:
            stats.start()

        for t in range(M + 2 * (K - 1)):
            sent_f: Dict[int, Tensor] = {}
            sent_b: Dict[int, Tensor] = {}
            for k in range(K):
                # forward: stage k runs microbatch t - k
                m_f = t - k
                h = None
                if 0 <= m_f < M:
                    with torch.no_grad():
                        x_in = embed(shared, cfg, tokens[m_f]) if k == 0 else fwd_recv[k]
                        stash[k][t % Q].copy_(x_in)
                        h = stage_apply(block, {p: w[k] for p, w in stacked.items()}, x_in)
                    if k < K - 1:
                        sent_f[k + 1] = h
                # backward: stage k runs microbatch t - (2(K-1) - k)
                m_b = t - (2 * (K - 1) - k)
                if not 0 <= m_b < M:
                    continue
                with saved.hooks():
                    if k == K - 1:
                        # the last stage seeds its backward from this tick's
                        # fresh output (m_b == m_f here) with ce_m / M
                        sh = _leaves(shared)
                        hh = h.detach().requires_grad_(True)
                        ce = cross_entropy(head_logits(sh, cfg, hh), labels[m_b])
                        dy, *dsh = torch.autograd.grad(
                            ce, [hh, *sh.values()], grad_outputs=torch.full_like(ce, 1.0 / M),
                            allow_unused=True)
                        _accumulate(g_shared, sh, dsh)
                        loss += ce.detach() / M
                    else:
                        dy = bwd_recv[k]
                    # recompute-backward from the stashed input
                    wk = _leaves({p: w[k] for p, w in stacked.items()})
                    x_saved = stash[k][(t - 2 * (K - 1 - k)) % Q].detach().requires_grad_(True)
                    h_re = stage_apply(block, wk, x_saved)
                    dx, *dw = torch.autograd.grad(h_re, [x_saved, *wk.values()],
                                                  grad_outputs=dy)
                    for p, g in zip(wk, dw):
                        g_stage[p][k] += g
                    if k > 0:
                        sent_b[k - 1] = dx  # ppermute back to the previous stage
                    else:
                        # stage 0's input gradient is the embedding's
                        sh = _leaves(shared)
                        x0 = embed(sh, cfg, tokens[m_b])
                        _accumulate(g_shared, sh, torch.autograd.grad(
                            x0, list(sh.values()), grad_outputs=dx, allow_unused=True))
            for k, x in sent_f.items():
                fwd_recv[k].copy_(x)
            for k, x in sent_b.items():
                bwd_recv[k].copy_(x)
            if stats is not None:
                stats.saved_bytes.append(saved.live)

        if stats is not None:
            stats.stash_slots = Q
            stats.held_bytes = _nbytes(stash[0], fwd_recv[0], bwd_recv[0])
        return loss, (g_stage, g_shared)

    return grad_fn


# ---------------------------------------------------------------------------
# dispatch + memory model
# ---------------------------------------------------------------------------


def make_schedule_grad(cfg: ModelConfig, num_stages: int, num_microbatches: int,
                       schedule: str = "fill_drain",
                       stats: Optional[ScheduleStats] = None) -> GradFn:
    """``grad_fn(stacked, shared, batch) -> (loss, (g_stacked, g_shared))``."""
    if schedule == "fill_drain":
        loss_fn = make_fill_drain_loss(cfg, num_stages, num_microbatches, stats)

        def grad_fn(stacked: Params, shared: Params, batch: Dict[str, Tensor]):
            sl, hl = _leaves(stacked), _leaves(shared)
            loss = loss_fn(sl, hl, batch)
            grads = torch.autograd.grad(loss, [*sl.values(), *hl.values()])
            return loss.detach(), (dict(zip(sl, grads[:len(sl)])),
                                   dict(zip(hl, grads[len(sl):])))

        return grad_fn
    if schedule == "1f1b":
        return make_1f1b_grad(cfg, num_stages, num_microbatches, stats)
    raise ValueError(f"unknown pipeline schedule {schedule!r}; one of {SCHEDULES}")


def make_local_grad(cfg: ModelConfig, num_stages: int, num_microbatches: int,
                    topology, schedule: str = "fill_drain"):
    """``grad_fn(stacked, shared, batch) -> (loss_r, (gs_r, gsh_r))``: the
    losses ``(R,)`` and local gradients ``{path: (R, K, per, ...)}`` and
    ``{path: (R, ...)}`` of the R = ``topology.data_shards`` data replicas,
    unreduced. Replica r takes its rows of each microbatch
    (``topology.replica_rows``, the reference's pod-major split over the
    flattened ``(pod, data)`` axes), and its loss and gradient are the
    schedule's on those rows alone: the mean over its own tokens, as on the
    reference's data replica."""
    grad_fn = make_schedule_grad(cfg, num_stages, num_microbatches, schedule)
    R = topology.data_shards

    def local_grad_fn(stacked: Params, shared: Params, batch: Dict[str, Tensor]):
        mb = batch["tokens"].shape[1]
        losses, out = [], None
        for r in range(R):
            lo, hi = topology.replica_rows(r, mb)
            loss, grads = grad_fn(stacked, shared,
                                  {k: v[:, lo:hi].contiguous() for k, v in batch.items()})
            if out is None:
                out = tuple({p: g.new_empty((R,) + tuple(g.shape)) for p, g in d.items()}
                            for d in grads)
            for acc, d in zip(out, grads):
                for p, g in d.items():
                    acc[p][r].copy_(g)
            del grads
            losses.append(loss)
        return torch.stack(losses), out

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
