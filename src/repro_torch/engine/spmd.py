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

On one card the stages run in one process (see ``engine.schedules``); one
rank per stage over ``torch.distributed``, the data axis and its
asynchronous form, and topologies are not ported yet. Checkpoints use the
reference's sharded format, one arrays file per stage, written by this one
process.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.checkpoint.convert import (
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
from repro_torch.engine.schedules import SCHEDULES, make_schedule_grad
from repro_torch.core.layout import tree_order_key
from repro_torch.models.model import Transformer, param_leaves
from repro_torch.optim.base import apply_updates, clip_by_global_norm
from repro_torch.optim.factory import build_optimizer
from repro_torch.pipeline.delay import stage_delayed_optimizer
from repro_torch.pipeline.partition import stage_context_for_stacked

Tensor = torch.Tensor
Params = Dict[str, Tensor]


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


def opt_leaves(stacked: Params, shared: Params) -> Params:
    """The ``(stacked, shared)`` pair as one ``{path: tensor}`` dict in the
    order ``tree_flatten`` gives the reference's tuple: every stacked leaf,
    then every shared leaf (``0/mixer/w_q``, ..., ``1/embed/embedding``)."""
    return {**{f"0/{k}": v for k, v in stacked.items()},
            **{f"1/{k}": v for k, v in shared.items()}}


def spmd_delay_specs(stacked: Params, shared: Params, num_stages: int):
    """Per-leaf delay specs of the stacked layout (``"stage"`` or an int)."""
    return stage_context_for_stacked(stacked, shared, num_stages).delay_specs()


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
    """

    name = "spmd"

    def __init__(self, cfg: ModelConfig, ocfg: OptimizerConfig, num_stages: int,
                 num_microbatches: int = 0, schedule: str = "fill_drain",
                 async_grads: bool = True, use_kernels: bool = False,
                 grad_clip: float = 1.0, device: Union[str, torch.device] = "cuda",
                 seed: int = 0, precision: Union[str, PrecisionPolicy, None] = None,
                 donate: Union[bool, str] = "auto"):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {schedule!r}; one of {SCHEDULES}")
        if cfg.scan_layers:
            raise ValueError("pipeline stacking starts from per-layer params (scan_layers=False)")
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
        self.grad_fn = make_schedule_grad(cfg, K, M, schedule)

        # the stage context from parameter shapes only: a weightless model
        meta = Transformer(cfg, device="meta", seed=None)
        stacked_s, shared_s = stack_stage_params(param_leaves(meta), cfg, K)
        ctx = stage_context_for_stacked(stacked_s, shared_s, K)
        self._leaf_shapes = {k: tuple(v.shape) for k, v in opt_leaves(stacked_s, shared_s).items()}
        base = build_optimizer(ocfg, opt_leaves(stacked_s, shared_s), cfg, num_stages=K,
                               apply_delay=False, use_kernels=use_kernels, stage_context=ctx)
        # delay compensation reads each stage's stale weights from the FIFO.
        # Per-stage factors of the delay-aware bases are built here from the
        # meta shapes on the host and follow the state to its device at
        # their first use
        self.opt = (stage_delayed_optimizer(base, ctx.delay_specs(), K,
                                            store_params=(ocfg.name == "delay_compensation"))
                    if async_grads and K > 1 else base)

    def init_state(self, params: Any = None) -> EngineState:
        """``params``: None (a model drawn from the engine's seed), a
        per-layer ``{path: tensor}`` dict, or a ``(stacked, shared)`` pair."""
        if params is None:
            params = param_leaves(Transformer(self.cfg, device=self.device, seed=self.seed))
        if isinstance(params, tuple):
            stacked, shared = params
        else:
            stacked, shared = stack_stage_params(params, self.cfg, self.num_stages)
        with torch.no_grad():
            stacked = {k: v.detach().to(self.device, torch.float32).clone()
                       for k, v in stacked.items()}
            shared = {k: v.detach().to(self.device, torch.float32).clone()
                      for k, v in shared.items()}
        return EngineState(params=(stacked, shared),
                           opt_state=self.opt.init(opt_leaves(stacked, shared)))

    def _shape_batch(self, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """(B, S) -> (M, B // M, S): equal microbatches, so that 1F1B's sum of
        ce_m / M equals fill-drain's joint mean."""
        tokens = batch["tokens"]
        if tokens.ndim == 3:  # already microbatched
            return batch
        M = self.num_microbatches
        B, S = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} must divide into {M} microbatches")
        return {k: v.reshape(M, B // M, S) for k, v in batch.items()}

    def step(self, state: EngineState, batch: Dict, t: int) -> Tuple[EngineState, Any, Dict]:
        stacked, shared = state.params
        loss, (gs, gsh) = self.grad_fn(stacked, shared, self._shape_batch(batch))
        grads = opt_leaves(gs, gsh)
        if self.grad_clip:
            # the step's own gradients: scaled where they lie
            grads = clip_by_global_norm(grads, self.grad_clip)
        params = opt_leaves(stacked, shared)
        with torch.no_grad():
            updates, opt_state = self.opt.update(grads, state.opt_state, params, t,
                                                 inplace=self.donate)
            if not self.donate:
                stacked = {k: v.clone() for k, v in stacked.items()}
                shared = {k: v.clone() for k, v in shared.items()}
                params = opt_leaves(stacked, shared)
            apply_updates(params, updates)  # in place: the step's stacked and shared tensors
        return EngineState((stacked, shared), opt_state), loss, {"ce": loss}

    def canonical_params(self, state: EngineState) -> Params:
        """Per-layer ``{path: tensor}``, e.g. for evaluation."""
        return unstack_stage_params(*state.params)

    # -- checkpointing -----------------------------------------------------

    def checkpoint_tree(self, state: EngineState) -> Any:
        """``((stacked, shared), opt_state)``: the reference's 2-tuple."""
        return (stacked_to_numpy(*state.params), opt_state_to_numpy(state.opt_state))

    def load_state(self, tree: Any) -> EngineState:
        params_tree, opt_tree = tree
        stacked, shared = stacked_from_numpy(params_tree, "cpu")
        got = {k: tuple(v.shape) for k, v in opt_leaves(stacked, shared).items()}
        if got != self._leaf_shapes:
            raise ValueError(f"checkpoint parameters {got} do not fit this engine's "
                             f"{self._leaf_shapes}")
        state = self.init_state((stacked, shared))
        opt_state_from_numpy(opt_tree, state.opt_state)
        return state

    def checkpoint_job(self, path: str, state: EngineState, step: int = 0,
                       meta: Optional[Dict] = None):
        """Per-stage-shard save: one arrays file per pipeline stage. The
        stacked parameters and their optimizer state are sliced on axis 0,
        the stage delay queues on axis 1; the shared leaves go whole to
        shard 0. The host snapshot is taken now, the returned closure only
        writes files."""
        from repro_torch.checkpoint.ckpt import snapshot_sharded, write_sharded_checkpoint

        axes = stage_shard_axes(*state.params, state.opt_state)
        snapshot = snapshot_sharded(self.checkpoint_tree(state), self.num_stages, axes)
        # one process, one data replica
        full_meta = {"topology": f"{self.num_stages}x1", "precision": self.precision,
                     "num_processes": 1, **(meta or {})}

        def write() -> None:
            write_sharded_checkpoint(path, snapshot, step=step, meta=full_meta)

        return write
