"""Physical pipeline backend: the SPMD engine. Port of ``repro/engine/spmd.py``.

Layers are split contiguously into K equal stages and kept stage-stacked:
each block leaf becomes one ``(K, per, ...)`` tensor, and the embedding,
position embedding, final norm and head are shared. The tick schedules
(``engine.schedules``: ``fill_drain`` or ``1f1b``) produce the synchronous
pipeline gradient; staleness is imposed by composing it with the per-stage
delay FIFO (``pipeline.delay.stage_delayed_optimizer``): stage k applies the
gradient computed tau_k = K-1-k steps ago, deterministic PipeDream
weight-stashing semantics. The optimizer is any ``build_optimizer`` base,
built from the stacked layout's ``StageContext``, so stage-aware refresh
periods act per stage slice and the basis-rotation products run batched
over the stacked layers.

Each process runs its slab of the (pod, stage, data) grid
(``Topology.process_slab``); a single-process run's slab is the whole grid.
In a multi-process run (``launch.distributed.init_distributed`` called
before the engine is built) a process holds only its stages' stacked
parameters, gradients, optimizer state and delay rings, runs only their
ticks (``engine.schedules``) and takes only its data replicas' rows of each
microbatch (``data.process_local_batches``). The shared leaves (embedding,
position embedding, final norm, head) and their state are replicated on
every process. A process's data replicas run one after another, each on
its rows of every microbatch, and their sums meet in ``_reduce``, the one
place where replicas combine: the stacked gradients are summed over the
processes that hold the same stages, the loss and the shared gradients
(each process's part, zeros off the first and last stage) over all of
them, then divided by the replica count; in one process the sums over
processes are the identity. The optimizer is
built over the slab's leaves with their global stage indices
(``StageContext.slab``, ``stage_delayed_optimizer(stage_offset=)``), and the
clip reads the norm of the whole gradient. With ``data_async`` and
``data_delay=D > 0`` the data axis is asynchronous, as in the reference
(DESIGN.md §12): each step computes the replicas' local gradients from the
current weights, applies the reduction of D steps ago from a FIFO in the
engine state, and enqueues this step's; the optimizer sees the total delay
tau_k + D. Checkpoints use the reference's sharded format, one arrays file
per stage, each written by its owner (``Topology.shard_owners``; one process
owns them all in a single-process run), the manifest by the main process.

MoE blocks stack like any other: expert stacks become ``(K, per, E, d,
d_ff)`` leaves, each microbatch routes as its own GShard group, and the
stage apply drops the blocks' auxiliary loss, as the reference's does. The
frontend configs are refused (``check_spmd_config``), because the
reference's engine is wrong on them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import map_leaves
from repro_torch.checkpoint.convert import (
    fifo_from_numpy,
    fifo_to_numpy,
    opt_state_from_numpy,
    opt_state_to_numpy,
    stacked_from_numpy,
    stacked_to_numpy,
    stage_shard_axes,
)
from repro_torch.configs.base import (
    PRECISION_POLICIES,
    ModelConfig,
    OptimizerConfig,
    PrecisionPolicy,
)
from repro_torch.engine.base import EngineState, PipelineEngine
from repro_torch.engine.schedules import (
    SCHEDULES,
    StageSlab,
    make_local_grad,
    make_schedule_grad,
)
from repro_torch.core.layout import tree_order_key
from repro_torch.launch.topology import Topology
from repro_torch.models.model import Transformer, param_leaves
from repro_torch.models.transformer import check_homogeneous
from repro_torch.launch import distributed
from repro_torch.optim.base import apply_updates, clip_by_global_norm
from repro_torch.optim.factory import build_optimizer
from repro_torch.pipeline.delay import stage_delayed_optimizer
from repro_torch.pipeline.partition import stage_context_for_stacked

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def check_spmd_config(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a config that the stage-stacked pipeline does
    not run: a pattern of mixed block kinds (``check_homogeneous``), and the
    frontend configs, on which the reference's engine is wrong: its
    ``_shape_batch`` (``repro/engine/spmd.py:419-428``) rebuilds the batch
    from tokens and labels alone, dropping the frontend prefix, and takes a
    (B, S, K) codebook batch as already microbatched."""
    check_homogeneous(cfg)
    if cfg.frontend is not None or cfg.num_codebooks > 1:
        raise ValueError(
            f"{cfg.name}: a frontend config ({cfg.frontend} frontend, {cfg.num_codebooks} "
            "codebook(s)) cannot run on the spmd backend: the reference's SpmdEngine drops "
            "the frontend prefix from its batch and reads a (B, S, K) codebook batch as "
            "already microbatched (repro/engine/spmd.py:419-428); use --backend sim")


def stack_stage_params(params: Params, cfg: ModelConfig, num_stages: int) -> Tuple[Params, Params]:
    """Per-layer ``{path: tensor}`` (``blocks/3/mixer/w_q``, ...) ->
    (stacked ``{mixer/w_q: (K, per, ...)}``, shared ``{embed/embedding: ...}``),
    each in the reference's leaf order."""
    L = cfg.num_layers
    if L % num_stages:
        raise ValueError(f"{num_stages} stages do not divide {L} layers")
    per = L // num_stages
    names = sorted({k.split("/", 2)[2] for k in params if k.startswith("blocks/")},
                   key=tree_order_key)
    stacked = {}
    for n in names:
        layers = [params[f"blocks/{l}/{n}"] for l in range(L)]
        stacked[n] = torch.stack(layers).reshape((num_stages, per) + tuple(layers[0].shape))
    shared = {k: v for k, v in params.items() if not k.startswith("blocks/")}
    return stacked, shared


def unstack_stage_params(stacked: Params, shared: Params) -> Params:
    """The inverse of ``stack_stage_params``: per-layer ``{path: tensor}`` in
    the reference's leaf order (views of the stacked tensors)."""
    K, per = next(iter(stacked.values())).shape[:2]
    out = dict(shared)
    for n, w in stacked.items():
        for k in range(K):
            for l in range(per):
                out[f"blocks/{k * per + l}/{n}"] = w[k, l]
    return {p: out[p] for p in sorted(out, key=tree_order_key)}


def make_pipeline_grad(cfg: ModelConfig, num_stages: int, num_microbatches: int,
                       schedule: str = "fill_drain"):
    """``grad_fn(stacked, shared, batch) -> (loss, (g_stacked, g_shared))``
    under the chosen tick schedule (``"fill_drain"`` or ``"1f1b"``)."""
    return make_schedule_grad(cfg, num_stages, num_microbatches, schedule)


def make_pipeline_loss(cfg: ModelConfig, num_stages: int, num_microbatches: int):
    """Fill-drain ``loss_fn(stacked, shared, batch) -> scalar``. Only
    fill-drain has a standalone differentiable loss; 1F1B builds its
    gradient explicitly (``make_pipeline_grad(schedule="1f1b")``)."""
    from repro_torch.engine.schedules import make_fill_drain_loss

    return make_fill_drain_loss(cfg, num_stages, num_microbatches)


def opt_leaves(stacked: Params, shared: Params) -> Params:
    """The ``(stacked, shared)`` pair as one ``{path: tensor}`` dict in the
    order ``tree_flatten`` gives the reference's tuple: every stacked leaf,
    then every shared leaf (``0/mixer/w_q``, ..., ``1/embed/embedding``)."""
    return {**{f"0/{k}": v for k, v in stacked.items()},
            **{f"1/{k}": v for k, v in shared.items()}}


def spmd_delay_specs(stacked: Params, shared: Params, num_stages: int):
    """Per-leaf delay specs of the stacked layout (``"stage"`` or an int)."""
    return stage_context_for_stacked(stacked, shared, num_stages).delay_specs()


def slab_optimizer(cfg: ModelConfig, ocfg: OptimizerConfig, num_stages: int,
                   stages: Tuple[int, int], data_delay: int = 0, use_kernels: bool = False,
                   async_grads: bool = True):
    """(optimizer, stacked meta leaves, shared meta leaves) of the SPMD step
    over the stages ``[k0, k1)`` of ``num_stages`` (all of them in a
    single-process run): a ``build_optimizer`` base from the stacked
    layout's ``StageContext`` cut to those stages, wrapped in the per-stage
    delay FIFO unless ``async_grads`` is off. The leaves are on the meta
    device: the context comes from parameter shapes only."""
    K, (k0, k1) = num_stages, stages
    stacked_s, shared_s = stack_stage_params(
        param_leaves(Transformer(cfg, device="meta", seed=None)), cfg, K)
    # delay-aware bases see the total delay tau_k + D; a slab keeps its
    # stages' global delays and the whole layout's refresh periods
    ctx = stage_context_for_stacked(stacked_s, shared_s, K, data_delay=data_delay)
    if (k0, k1) != (0, K):
        stacked_s = {k: v[k0:k1] for k, v in stacked_s.items()}
        ctx = ctx.slab(k0, k1)
    base = build_optimizer(ocfg, opt_leaves(stacked_s, shared_s), cfg, num_stages=K,
                           apply_delay=False, use_kernels=use_kernels, stage_context=ctx)
    if not async_grads:
        return base, stacked_s, shared_s
    # delay compensation reads each stage's stale weights from the FIFO,
    # D steps deeper under a deferred reduction. Per-stage factors of the
    # delay-aware bases are built here from the meta shapes on the host and
    # follow the state to its device at their first use
    return (stage_delayed_optimizer(base, ctx.delay_specs(), K,
                                    store_params=(ocfg.name == "delay_compensation"),
                                    extra_param_delay=data_delay, stage_offset=k0),
            stacked_s, shared_s)


class SpmdEngine(PipelineEngine):
    """Pipeline gradients under a tick schedule, composed with the per-stage
    delay FIFO around a ``build_optimizer`` base.

    ``async_grads=False`` drops the FIFO: the synchronous gradient, which is
    the same optimisation problem as the one-stage simulation.
    ``use_kernels=True`` routes attention through the flash-attention
    kernels (B1-B3) and the basis-rotation products and Adam scale through
    B4 and B5. ``precision`` (a ``PRECISION_POLICIES`` name or a policy;
    None leaves ``cfg`` as it is) sets the compute dtype: under ``bf16``
    the schedules run on bfloat16 copies of the weights, while the
    masters, the gradients and the optimizer state stay float32.
    ``device`` is where the state lives and the step runs; ``seed`` draws
    the initial model when ``init_state`` is given none.

    ``donate`` is the reference's donated step (``donate_argnums=(0, 1,
    2)``): with it the step rewrites the stacked and shared parameters and
    the optimizer state, delay rings included, in their own tensors, so the
    state passed in must not be read again (the loop always threads the
    returned one forward, and checkpoints copy to the host before the next
    step). ``donate=False`` keeps the copying step: the ``EngineState``
    passed in is left untouched, parameters included, at the cost of a
    second copy of the parameters and optimizer state. ``"auto"`` donates
    on a CUDA device and copies on the CPU, where the reference's
    ``"auto"`` does not donate either.

    ``topology`` (default: K stages, one data replica) sets the data
    replicas R = ``topology.data_shards``; each microbatch's rows must
    divide over them. With R > 1 and a synchronous data axis the step
    reduces the replicas' gradients at once. ``data_async=True,
    data_delay=D`` with D > 0 applies instead the reduction of D steps ago
    (zeros for the first D steps, on which the optimizer still updates);
    the reductions in flight are ``EngineState.data_fifo`` and the
    checkpoint tree's third element. ``data_delay=0`` is the synchronous
    step, bit for bit. A FIFO entry is never written: the step clips a copy.
    """

    name = "spmd"

    def __init__(self, cfg: ModelConfig, ocfg: OptimizerConfig, num_stages: int,
                 num_microbatches: int = 0, schedule: str = "fill_drain",
                 async_grads: bool = True, use_kernels: bool = False,
                 grad_clip: float = 1.0, device: Union[str, torch.device] = "cuda",
                 seed: int = 0, precision: Union[str, PrecisionPolicy, None] = None,
                 donate: Union[bool, str] = "auto", topology: Optional[Topology] = None,
                 data_async: bool = False, data_delay: int = 0):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {schedule!r}; one of {SCHEDULES}")
        if cfg.scan_layers:
            raise ValueError("pipeline stacking starts from per-layer params (scan_layers=False)")
        check_spmd_config(cfg)
        if isinstance(precision, str):
            precision = PRECISION_POLICIES[precision]
        if precision is not None:
            cfg = precision.apply(cfg)
        self.precision = (precision.name if precision is not None
                          else ("bf16_compute" if cfg.dtype == "bfloat16" else "f32"))
        if use_kernels:
            cfg = cfg.replace(use_kernels=True)
        self.cfg = cfg
        self.schedule = schedule
        self.num_stages = K = num_stages
        self.num_microbatches = M = num_microbatches or num_stages
        self.device = torch.device(device)
        self.donate = self.device.type == "cuda" if donate == "auto" else bool(donate)
        self.grad_clip = grad_clip
        self.seed = seed
        topology = topology if topology is not None else Topology(stages=K)
        if topology.stages != K:
            raise ValueError(f"topology {topology.describe()} has {topology.stages} stages "
                             f"but the engine was asked for {K}")
        self.topology = topology
        # data_delay == 0 is the synchronous step at construction: the same
        # step, optimizer and checkpoint layout
        self.data_async = bool(data_async)
        self.data_delay = int(data_delay)
        if self.data_delay < 0:
            raise ValueError(f"data_delay must be >= 0, got {self.data_delay}")
        if self.data_delay > 0 and not self.data_async:
            raise ValueError("data_delay > 0 requires data_async=True")
        self._data_eff = self.data_async and self.data_delay > 0
        D = self.data_delay if self._data_eff else 0
        # the process grid: one process holds the whole grid unless
        # init_distributed made this one of several
        self.num_processes = P = distributed.process_count()
        self.slab = topology.process_slab(P, distributed.process_index())
        k0, k1 = self.slab.stages
        self._setup_processes(P)

        self.opt, stacked_s, shared_s = slab_optimizer(
            cfg, ocfg, K, (k0, k1), data_delay=D, use_kernels=use_kernels,
            async_grads=async_grads and (K > 1 or self._data_eff))
        self._stacked_shapes = {k: tuple(v.shape) for k, v in stacked_s.items()}
        self._shared_shapes = {k: tuple(v.shape) for k, v in shared_s.items()}
        self._leaf_shapes = {k: tuple(v.shape) for k, v in opt_leaves(stacked_s, shared_s).items()}

    def _setup_processes(self, P: int) -> None:
        """This process's part of a P-process run (P = 1: the whole grid):
        its neighbours across the slab's edges, the transport and the groups
        its sums run over, its schedule and its data replicas' loop."""
        topo, me = self.topology, distributed.process_index()
        distributed.assert_process_slabs(topo, P)
        slabs = [topo.process_slab(P, p) for p in range(P)]
        k0, k1 = self.slab.stages

        def holder(stage: int) -> Optional[int]:
            return next((p for p, s in enumerate(slabs) if s.stages[0] <= stage < s.stages[1]
                         and s.data_shards == self.slab.data_shards), None)

        # one process sends nothing: its transport only counts zero bytes
        tr = self.transport = (distributed.transport() if P > 1
                               else distributed.Transport("none", self.device, staged=False))
        # the processes that hold the same stages (their data replicas sum);
        # new_group is collective, so every process makes every group
        groups = sorted({tuple(p for p, s in enumerate(slabs) if s.stages == x.stages)
                         for x in slabs})
        for g in groups:
            if len(g) > 1:
                tr.group(g)
        self._data_group = next(g for g in groups if me in g)
        self._world = tuple(range(P))
        # a deferred reduction over processes: the data axis's sums leave the
        # step, and the stage axis's (the processes that hold the same data
        # shards: each holds its part of the loss and the shared gradients)
        # stay in it
        self._defer = self._data_eff and len(self._data_group) > 1
        if self._defer:
            stage_groups = sorted({tuple(p for p, s in enumerate(slabs)
                                         if s.data_shards == x.data_shards) for x in slabs})
            for g in stage_groups:
                if 1 < len(g) < P:
                    tr.group(g)
            self._stage_group = next(g for g in stage_groups if me in g)
        self._slabs = slabs
        self.grad_fn = make_schedule_grad(
            self.cfg, self.num_stages, self.num_microbatches, self.schedule,
            slab=StageSlab(k0, k1, holder(k0 - 1) if k0 > 0 else None,
                           holder(k1) if k1 < self.num_stages else None, tr))
        lo, hi = self.slab.data_shards
        self.local_grad_fn = make_local_grad(self.grad_fn, hi - lo)

    def init_state(self, params: Any = None) -> EngineState:
        """``params``: None (a model drawn from the engine's seed), a
        per-layer ``{path: tensor}`` dict, or a ``(stacked, shared)`` pair."""
        if params is None:
            params = param_leaves(Transformer(self.cfg, device=self.device, seed=self.seed))
        if isinstance(params, tuple):
            stacked, shared = params
        else:
            stacked, shared = stack_stage_params(params, self.cfg, self.num_stages)
        k0, k1 = self.slab.stages
        if next(iter(stacked.values())).shape[0] != k1 - k0:
            stacked = {k: v[k0:k1] for k, v in stacked.items()}  # this process's slab
        with torch.no_grad():
            stacked = {k: v.detach().to(self.device, torch.float32).clone()
                       for k, v in stacked.items()}
            shared = {k: v.detach().to(self.device, torch.float32).clone()
                      for k, v in shared.items()}
        # warm-up: the first D steps apply zero reductions, the data axis's
        # analogue of the delay FIFO's zero-gradient warm-up. No step writes
        # into a FIFO entry, so the D entries may share one zero tree
        fifo = [self._zero_gbar()] * self.data_delay if self._data_eff else None
        return EngineState(params=(stacked, shared),
                           opt_state=self.opt.init(opt_leaves(stacked, shared)),
                           data_fifo=fifo)

    def _zero_gbar(self) -> Tuple[Params, Params]:
        """A zero reduction: float32 ``(g_stacked, g_shared)`` on the device."""
        return tuple({k: torch.zeros(sh, dtype=torch.float32, device=self.device)
                      for k, sh in shapes.items()}
                     for shapes in (self._stacked_shapes, self._shared_shapes))

    def _shape_batch(self, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """(B, S) -> (M, B // M, S): equal microbatches, so that 1F1B's sum of
        ce_m / M equals fill-drain's joint mean. Each microbatch's rows must
        divide over the topology's data shards."""
        tokens = batch["tokens"]
        if self.num_processes > 1:
            return self._check_process_batch(batch)
        if tokens.ndim != 3:
            M = self.num_microbatches
            B, S = tokens.shape
            if B % M:
                raise ValueError(f"batch {B} must divide into {M} microbatches")
            batch = {k: v.reshape(M, B // M, S) for k, v in batch.items()}
        mb, shards = batch["tokens"].shape[1], self.topology.data_shards
        if mb % shards:
            raise ValueError(f"microbatch size {mb} must divide over the {shards} data shards "
                             f"of topology {self.topology.describe()}")
        return batch

    def _check_process_batch(self, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """A multi-process batch arrives microbatched with this process's
        data shards' rows alone (``data.process_local_batches``)."""
        lo, hi = self.slab.data_shards
        t = batch["tokens"]
        if t.ndim != 3 or t.shape[0] != self.num_microbatches or t.shape[1] % (hi - lo):
            raise ValueError(
                f"multi-process batches must arrive microbatched "
                f"(process_local_batches) with the rows of data shards [{lo}, {hi}); "
                f"got tokens of shape {tuple(t.shape)}")
        return batch

    def _reduce(self, loss: Tensor, grads: Tuple[Params, Params]
                ) -> Tuple[Tensor, Tuple[Params, Params]]:
        """The mean over the R data replicas of their losses and local
        gradients, from this process's sums of its own replicas'
        (``local_grad_fn``): the only place where data replicas combine. The
        stacked gradients are summed over the processes that hold the same
        stages, the loss and the shared gradients over all processes."""
        gs, gsh = grads
        with torch.no_grad():
            self.transport.sum_(list(gs.values()), self._data_group)
            loss = loss.reshape(1)
            self.transport.sum_([loss, *gsh.values()], self._world)
            loss = loss[0]
            R = self.topology.data_shards
            if R > 1:
                loss = loss / R
                for d in (gs, gsh):
                    for g in d.values():
                        g.div_(R)
        return loss, (gs, gsh)

    def _reduce_deferred(self, loss: Tensor, grads: Tuple[Params, Params]):
        """``_reduce`` with its data-axis sums left in flight: the stage
        axis's sum of the loss's and the shared gradients' parts now, then
        the data group's sums started without waiting, the loss's first (the
        step waits for it at its end, not for the gradients'). Returns the
        loss's ``PendingSum`` and the gradients' ``_PendingReduction``."""
        gs, gsh = grads
        with torch.no_grad():
            loss = loss.reshape(1)
            self.transport.sum_([loss, *gsh.values()], self._stage_group)
            loss_sum = self.transport.sum_async([loss], self._data_group)
            grad_sum = self.transport.sum_async([*gs.values(), *gsh.values()], self._data_group)
        return loss_sum, _PendingReduction(grad_sum, gs, gsh, self.topology.data_shards)

    def _global_norm(self, gs: Params, gsh: Params) -> Tensor:
        """The norm of the whole gradient from this process's slab: each
        stacked leaf's sum of squares over the processes (one process of
        each data group counts its slab), the shared leaves' counted once,
        added in the single-process leaf order (``optim.base.global_norm``'s
        bits in one process). A deferred reduction is the same on every
        data replica, so there the sum runs over the stage axis alone."""
        sq = torch.stack([torch.sum(torch.square(g.float())) for g in gs.values()])
        if self._defer:
            self.transport.sum_([sq], self._stage_group)
        else:
            if distributed.process_index() != self._data_group[0]:
                sq.zero_()
            self.transport.sum_([sq], self._world)
        terms = [*sq.unbind(), *(torch.sum(torch.square(g.float())) for g in gsh.values())]
        return torch.sqrt(sum(terms))

    def _fresh_grads(self, stacked: Params, shared: Params, batch: Dict[str, Tensor]):
        """This step's loss and gradients, reduced over the data replicas."""
        return self._reduce(*self.local_grad_fn(stacked, shared, batch))

    def step(self, state: EngineState, batch: Dict, t: int) -> Tuple[EngineState, Any, Dict]:
        stacked, shared = state.params
        batch = self._shape_batch(batch)
        fifo = loss_sum = None
        if self._defer:
            # the data group's sums of this step's local gradients go in
            # flight into the FIFO; the one of D steps ago is waited for
            loss_sum, fresh = self._reduce_deferred(
                *self.local_grad_fn(stacked, shared, batch))
        else:
            loss, fresh = self._fresh_grads(stacked, shared, batch)
        if self._data_eff:
            # enqueue this step's reduction; apply the one of D steps ago
            fifo = list(state.data_fifo)
            fifo.append(fresh)
            gs, gsh = _settled(fifo.pop(0))
        else:
            gs, gsh = fresh
        grads = opt_leaves(gs, gsh)
        if self.grad_clip:
            # the step's own gradients are scaled where they lie; a popped
            # reduction out of place, so that no FIFO entry is ever written
            grads = clip_by_global_norm(grads, self.grad_clip, inplace=not self._data_eff,
                                        norm=self._global_norm(gs, gsh))
        params = opt_leaves(stacked, shared)
        with torch.no_grad():
            updates, opt_state = self.opt.update(grads, state.opt_state, params, t,
                                                 inplace=self.donate)
            if not self.donate:
                stacked = {k: v.clone() for k, v in stacked.items()}
                shared = {k: v.clone() for k, v in shared.items()}
                params = opt_leaves(stacked, shared)
            apply_updates(params, updates)  # in place: the step's stacked and shared tensors
        if loss_sum is not None:
            loss = loss_sum.wait()[0][0] / self.topology.data_shards
        return EngineState((stacked, shared), opt_state, data_fifo=fifo), loss, {"ce": loss}

    def canonical_params(self, state: EngineState) -> Optional[Params]:
        """Per-layer ``{path: tensor}``, e.g. for evaluation. In a
        multi-process run every process must call it: the first process of
        each stage range sends its slab to the main process, which returns
        the whole model; the others return None."""
        stacked, shared = state.params
        if self.num_processes == 1:
            return unstack_stage_params(stacked, shared)
        me = distributed.process_index()
        heads = {}  # stage range -> the first process that holds it
        for p, s in enumerate(self._slabs):
            heads.setdefault(s.stages, p)
        if me != 0:
            if heads[self.slab.stages] == me:
                self.transport.exchange([(v, 0) for v in stacked.values()], [])
            return None
        parts = {self.slab.stages: stacked}
        for rng, p in heads.items():
            if p == 0:
                continue
            bufs = {k: torch.empty((rng[1] - rng[0],) + tuple(v.shape[1:]), dtype=v.dtype,
                                   device=v.device) for k, v in stacked.items()}
            self.transport.exchange([], [(b, p) for b in bufs.values()])
            parts[rng] = bufs
        order = sorted(parts)
        whole = {k: torch.cat([parts[r][k] for r in order]) for k in stacked}
        return unstack_stage_params(whole, shared)

    # -- checkpointing -----------------------------------------------------

    def checkpoint_tree(self, state: EngineState) -> Any:
        """``((stacked, shared), opt_state)``, the reference's 2-tuple, and
        under a deferred reduction the FIFO as its third element, so that a
        resumed run applies the same reductions."""
        tree = (stacked_to_numpy(*state.params), opt_state_to_numpy(state.opt_state))
        if self._data_eff:
            tree += (fifo_to_numpy(_settle_fifo(state)),)
        return tree

    def load_state(self, tree: Any) -> EngineState:
        """From a ``checkpoint_tree``; a synchronous 2-tuple warm-starts a
        deferred reduction with a zero FIFO, as the reference does."""
        params_tree, opt_tree, *rest = tree
        fifo_tree = rest[0] if rest else None
        if self._data_eff and fifo_tree is not None and len(fifo_tree) != self.data_delay:
            raise ValueError(f"checkpoint FIFO depth {len(fifo_tree)} does not match "
                             f"data_delay={self.data_delay}")
        k0, k1 = self.slab.stages
        slabbed = (k0, k1) != (0, self.num_stages)
        if slabbed:
            # a checkpoint holds every stage: this process takes its slab
            params_tree = (map_leaves(params_tree[0], lambda i, a: a[k0:k1]), params_tree[1])
        stacked, shared = stacked_from_numpy(params_tree, "cpu")
        got = {k: tuple(v.shape) for k, v in opt_leaves(stacked, shared).items()}
        if got != self._leaf_shapes:
            raise ValueError(f"checkpoint parameters {got} do not fit this engine's "
                             f"{self._leaf_shapes}")
        if slabbed and self._data_eff and fifo_tree is not None:
            fifo_tree = tuple((map_leaves(st, lambda i, a: a[k0:k1]), sh)
                              for st, sh in fifo_tree)
        if self._data_eff and fifo_tree is not None:
            fifo = fifo_from_numpy(fifo_tree, self.device)
            for i, entry in enumerate(fifo):
                shapes = {k: tuple(v.shape) for k, v in opt_leaves(*entry).items()}
                if shapes != self._leaf_shapes:
                    raise ValueError(f"checkpoint FIFO entry {i}: {shapes} do not fit this "
                                     f"engine's {self._leaf_shapes}")
        state = self.init_state((stacked, shared))
        if slabbed:
            n = len(stacked) + len(shared)
            axes = stage_shard_axes(stacked, shared, state.opt_state)[n:]
            opt_tree = map_leaves(opt_tree, lambda i, a: a if axes[i] is None else np.take(
                a, range(k0, k1), axis=axes[i]))
        opt_state_from_numpy(opt_tree, state.opt_state)
        if self._data_eff and fifo_tree is not None:
            state.data_fifo = fifo
        return state

    def checkpoint_job(self, path: str, state: EngineState, step: int = 0,
                       meta: Optional[Dict] = None):
        """Per-stage-shard save: one arrays file per pipeline stage. The
        stacked parameters, their optimizer state and the FIFO's stacked
        gradients are sliced on axis 0, the stage delay queues on axis 1;
        the shared leaves go whole to shard 0. The host snapshot is taken
        now, the returned closure only writes files. In a multi-process run
        every process calls this at the same step and writes the shards
        that ``Topology.shard_owners`` gives it; the barriers live in the
        write, so every process's writer must run its jobs in order."""
        from repro_torch.checkpoint.ckpt import snapshot_sharded, write_sharded_checkpoint

        axes = stage_shard_axes(*state.params, state.opt_state,
                                data_fifo=_settle_fifo(state) if self._data_eff else None)
        kw, owned = {}, None
        if self.num_processes > 1:
            # this process writes the shards it owns; the main one the manifest
            me = distributed.process_index()
            owned = [s for s, p in enumerate(self.topology.shard_owners(self.num_processes))
                     if p == me]
            kw = dict(write_manifest=distributed.is_main(), barrier=distributed.barrier)
        snapshot = snapshot_sharded(self.checkpoint_tree(state), self.num_stages, axes,
                                    owned_shards=owned, held_shards=self.slab.stages)
        full_meta = {"topology": self.topology.describe(), "precision": self.precision,
                     "num_processes": self.num_processes, **(meta or {})}

        def write() -> None:
            write_sharded_checkpoint(path, snapshot, step=step, meta=full_meta, **kw)

        return write


class _PendingReduction:
    """A FIFO entry whose data-group sum is still in flight: the local
    gradients ``(gs, gsh)`` that the ``PendingSum`` writes the sums into,
    divided by the replica count R once waited for."""

    def __init__(self, pending, gs: Params, gsh: Params, replicas: int):
        self.pending, self.grads, self.replicas = pending, (gs, gsh), replicas

    def result(self) -> Tuple[Params, Params]:
        if self.pending is not None:
            self.pending.wait()
            self.pending = None
            with torch.no_grad():
                for d in self.grads:
                    for g in d.values():
                        g.div_(self.replicas)
        return self.grads


def _settled(entry) -> Tuple[Params, Params]:
    """A FIFO entry's ``(g_stacked, g_shared)``, waiting for its sums."""
    return entry.result() if isinstance(entry, _PendingReduction) else entry


def _settle_fifo(state: EngineState) -> list:
    """Wait for every sum in flight in ``state.data_fifo`` and keep the
    results in place of the pending entries; returns the FIFO."""
    state.data_fifo[:] = [_settled(e) for e in state.data_fifo]
    return state.data_fifo
