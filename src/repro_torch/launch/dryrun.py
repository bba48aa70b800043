"""Dry run: trace every (architecture x input shape) step on the ``meta``
device, where tensors have shapes and no data, and report its roofline
terms and memory without a card. Port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch jamba_v0_1_52b \\
        --shape long_500k --multi-pod

For one (arch, shape) it builds the model (the config's own layout:
``scan_layers=True``, stacked superblocks under remat) and, for a train
shape, the optimizer and its state on ``meta``, then runs the shape's step
once: ``make_train_step`` (loss, gradients, clip, update, apply),
``make_prefill_step`` or ``make_serve_step``. While it runs, one dispatch
mode (``StepTrace``) counts the FLOPs of the matrix products by
``FlopCounterMode``'s own table (``torch.utils.flop_counter.flop_registry``;
``FlopCounterMode`` itself hooks every module, and its hooks keep
activations alive past their autograd lifetime: 30 GB more peak at
qwen3_0_6b, 4 layers, 16 x 4,096 tokens), adds up the bytes that every
operation reads and writes (inputs plus outputs; views move nothing) and
follows the live storages the step allocates, whose peak beside the
step's arguments (parameters, optimizer state, batch, decode cache) is the
peak of live bytes. The kernels take their plain versions on ``meta``, as the
reference's dry run runs with ``use_kernels=False``; with ``use_kernels``
the optimizer runs the grouped steps of the kernel path (their plain
versions, so the same products and transients). The trace runs every
layer, so the reference's extrapolation from one and two superblocks
(XLA counts a loop body once) has no counterpart: ``--no-extrap`` skips
the FLOP and byte counts and keeps the memory. The step traced is step 0,
a basis refresh's (the heavier one in memory: the grams, their products
and the QR).

The grid. The reference compiles for the production mesh (data 16, model
16), or (pod 2, data 16, model 16) with ``--multi-pod``, placing every
argument by its sharding rules. The port runs data parallelism between
processes and has no tensor-parallel ``model`` axis, so a row's step is one
data replica's on one card: the global batch over pods x 16 replicas (at
least one row), with the reference's ``model`` axis folded onto that card.
``mesh`` says so, and ``fits`` holds the peak against the card's 80 GB.
The collective term is the data axis's gradient reduction reckoned for
that grid (a ring all-reduce of the float32 gradients over the replicas);
nothing measures it. Beside it, ``sharded`` gives what one device of the
row's ``reference_mesh`` would hold under the ported rules
(``repro_torch.sharding``), placed as the reference's ``_compile`` places
its arguments: the parameters by ``params_pspecs``, the optimizer state by
``opt_state_pspecs``, the global batch by ``tokens_pspec`` and a decode
cache by ``cache_pspecs``; its bytes, with no activations (the reference
reads those from XLA's per-device memory analysis). ``--grad-rs`` and
``--seq-shard`` act on the ``model`` axis at run time and are refused by
name: the rules are ported, but the port has no tensor-parallel runtime to
apply them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import weakref
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (
    ARCH_IDS,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    OptimizerConfig,
    get_config,
)
from repro_torch.launch.roofline import (
    CARD_BYTES,
    peak_flops_for,
    ring_all_reduce_bytes,
    roofline_from_trace,
)
from repro_torch.models.model import (
    Transformer,
    cast_params,
    forward_decode,
    forward_features,
    init_cache,
    logits_from_features,
    loss_fn,
    param_leaves,
    shared_leaves,
)
from repro_torch.optim.base import apply_updates, clip_by_global_norm
from repro_torch.optim.factory import build_optimizer
from repro_torch.sharding import (
    cache_pspecs,
    opt_state_pspecs,
    params_pspecs,
    sharded_bytes,
    tokens_pspec,
)

Tensor = torch.Tensor

# Big architectures use the paper's memory-efficient estimation strategy
# (S=1st, G=unilateral; Appendix H) in the production dry-run; the rest use
# the paper default (2nd/bilateral).
BIG_ARCHS = {"llava_next_34b", "mixtral_8x22b", "jamba_v0_1_52b", "deepseek_v2_236b"}

DATA_AXIS = 16  # the reference's production mesh: data 16, model 16 (pods 2)
MODEL_AXIS = 16
TRACE_STEP = 0  # a refresh step of basis rotation
SHARDING_FLAGS = ("--grad-rs", "--seq-shard")


def rotation_strategy(arch: str) -> Tuple[str, str]:
    return ("1st", "unilateral") if arch in BIG_ARCHS else ("2nd", "bilateral")


def grid(multi_pod: bool) -> Dict[str, int]:
    """The data axes of the production grid: (pod 2,) data 16."""
    return {"pod": 2, "data": DATA_AXIS} if multi_pod else {"data": DATA_AXIS}


def replica_batch(shape: InputShape, replicas: int) -> int:
    """Rows of one data replica: the global batch over the replicas, at
    least one (``long_500k``'s single sequence runs whole on each)."""
    return max(1, shape.global_batch // replicas)


# ---------------------------------------------------------------------------
# Inputs (on meta: shapes, no data)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: InputShape, batch: int, seq: Optional[int] = None,
                device: torch.device | str = "meta") -> Dict[str, Any]:
    """One replica's inputs for ``shape`` at ``batch`` rows (``seq`` tokens,
    the shape's own by default): a train or prefill batch (tokens and
    labels, (B, S) or (B, S, K) with K codebooks, after a vision prefix of
    ``frontend_tokens`` embeddings inside the S), or a decode step's token,
    cache of S positions and position S - 1."""
    S = seq or shape.seq_len
    K = cfg.num_codebooks
    if shape.mode in ("train", "prefill"):
        n_front = cfg.frontend_tokens if cfg.frontend == "vision" else 0
        S_text = S - n_front
        if S_text <= 0:
            raise ValueError(f"{shape.name}: {S} tokens leave no text after a prefix of {n_front}")
        tok = (batch, S_text, K) if K > 1 else (batch, S_text)
        out = {"tokens": torch.zeros(tok, dtype=torch.int64, device=device),
               "labels": torch.zeros(tok, dtype=torch.int64, device=device)}
        if n_front:
            out["frontend"] = torch.zeros((batch, n_front, cfg.frontend_dim),
                                          dtype=torch.float32, device=device)
        return out
    tok = (batch, 1, K) if K > 1 else (batch, 1)
    return {"token": torch.zeros(tok, dtype=torch.int64, device=device),
            "cache": init_cache(cfg, batch, S, device=device), "pos": S - 1}


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, opt, microbatches: int = 1):
    """``train_step(model, opt_state, batch, step) -> (model, opt_state,
    loss)``: the loss's gradients (accumulated in float32 over
    ``microbatches`` equal row blocks, one block's activations alive at a
    time), clipped to a global norm of 1, the optimizer's update
    (written into its own state, the reference's donated step) and the
    update applied to the model's parameters in place. ``model.cfg`` should
    be ``cfg``."""

    def grads_of(model: Transformer, batch: Dict[str, Tensor]):
        params = param_leaves(model)
        loss, _ = loss_fn(model, batch)
        gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                               for (k, p), g in zip(params.items(), gs)}

    def train_step(model: Transformer, opt_state, batch: Dict[str, Tensor], step: int):
        if microbatches > 1:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not divide into {microbatches} microbatches")
            w = B // microbatches
            loss, grads = None, None
            for i in range(microbatches):
                l, g = grads_of(model, {k: v[i * w:(i + 1) * w] for k, v in batch.items()})
                if grads is None:
                    loss = l / microbatches
                    grads = {k: x.float() / microbatches for k, x in g.items()}
                else:
                    loss = loss + l / microbatches
                    for k, x in g.items():
                        grads[k].add_(x.float() / microbatches)
                del g
        else:
            loss, grads = grads_of(model, batch)
        grads = clip_by_global_norm(grads, 1.0)
        params = param_leaves(model)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params, step, inplace=True)
            del grads
            apply_updates(params, updates)
        return model, opt_state, loss

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(model, batch) -> (B, V)`` next-token logits (the
    reference's ``forward_train(...)[:, -1]``; the head runs on the last
    position alone, so the (B, S, V) logits are never formed)."""

    def prefill_step(model: Transformer, batch: Dict[str, Tensor]) -> Tensor:
        with torch.no_grad():
            x, _ = forward_features(model, batch["tokens"], batch.get("frontend"))
            shared = cast_params(shared_leaves(model), cfg.compute_dtype)
            return logits_from_features(shared, cfg, x[:, -1])

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(model, token, cache, pos) -> (logits, cache)``: one
    decode step, the cache written in place."""

    def serve_step(model: Transformer, token: Tensor, cache, pos: int):
        with torch.no_grad():
            return forward_decode(model, token, cache, pos)

    return serve_step


# ---------------------------------------------------------------------------
# FLOPs accounting
# ---------------------------------------------------------------------------


def param_counts(params: Dict[str, Tensor], cfg: ModelConfig) -> Tuple[int, int]:
    """(total, active) parameter counts from shapes (active: MoE top-k)."""
    total = active = 0
    for path, x in params.items():
        n = x.numel()
        total += n
        if path.split("/")[-1].endswith("_e") and cfg.moe is not None:
            active += n * cfg.moe.top_k // cfg.moe.num_experts
        else:
            active += n
    return total, active


def model_flops(cfg: ModelConfig, shape: InputShape, n_active: int) -> float:
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------


def tensor_bytes(tree: Any) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, Tensor):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class StepTrace(TorchDispatchMode):
    """Counts, for the operations run under it, when ``count``: their FLOPs
    (``flop_registry``'s, as ``FlopCounterMode`` counts them) and the bytes
    each reads and writes (its tensor inputs plus its outputs; view
    operations move nothing); and always the storages they allocate, while
    they live, with their peak. Storages that existed when the trace began
    (``held``: the step's arguments) are not counted as allocated."""

    def __init__(self, held: Iterable[Tensor] = (), count: bool = True):
        super().__init__()
        self.count = count
        self.flops = 0
        self.hbm_bytes = 0
        self.live = 0
        self.peak = 0
        self._held = {t.untyped_storage()._cdata for t in held}
        self._live: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def _track(self, t: Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held or key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, Tensor)]
        for t in outs:
            self._track(t)
        if self.count:
            count_flops = flop_registry.get(func._overloadpacket)
            if count_flops is not None:
                self.flops += count_flops(*args, **(kwargs or {}), out_val=out)
            if not func.is_view:
                ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, Tensor)]
                self.hbm_bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


def trace_step(fn: Callable, args: Tuple, held: Any, count: bool = True) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under the counters: FLOPs (``count``), HBM
    bytes (``count``), the argument bytes (``held``'s storages), the peak of
    the storages allocated beside them, and the bytes of what it returns."""
    held_list = [t for t in tree_leaves(held) if isinstance(t, Tensor)]
    tr = StepTrace(held_list, count=count)
    t0 = time.time()
    with tr:
        out = fn(*args)
    return {"flops": float(tr.flops),
            "hbm_bytes": float(tr.hbm_bytes), "argument_bytes": tensor_bytes(held_list),
            "temp_bytes": tr.peak, "output_bytes": tensor_bytes(out),
            "trace_s": time.time() - t0}


def build_step(cfg: ModelConfig, shape: InputShape, batch: int, seq: Optional[int],
               optimizer: str, rotation: Tuple[str, str], microbatches: int,
               use_kernels: bool, device: torch.device | str = "meta"):
    """(model, step function, its arguments, the arguments' tensors) of one
    replica's step of ``shape`` on ``device``."""
    model = Transformer(cfg, device=device, seed=None)
    inputs = input_specs(cfg, shape, batch, seq, device)
    if shape.mode == "train":
        src, geom = rotation
        ocfg = OptimizerConfig(name=optimizer, rotation_source=src, rotation_geometry=geom,
                               rotation_freq=10, total_steps=10_000)
        params = param_leaves(model)
        opt = build_optimizer(ocfg, params, cfg, num_stages=1, apply_delay=False,
                              use_kernels=use_kernels)
        state = opt.init(params)
        fn = make_train_step(cfg, opt, microbatches)
        return model, fn, (model, state, inputs, TRACE_STEP), (params, state, inputs)
    if shape.mode == "prefill":
        return model, make_prefill_step(cfg), (model, inputs), (param_leaves(model), inputs)
    fn = make_serve_step(cfg)
    return (model, fn, (model, inputs["token"], inputs["cache"], inputs["pos"]),
            (param_leaves(model), inputs["token"], inputs["cache"]))


def sharded_figures(cfg: ModelConfig, shape: InputShape, params: Dict[str, Tensor],
                    opt_state: Any, mesh_shape: Dict[str, int],
                    seq: Optional[int] = None) -> Dict[str, Any]:
    """Bytes one device of ``mesh_shape`` holds of a step's arguments under
    the sharding rules, as the reference's ``_compile`` places them: the
    parameters, the optimizer state (train), and the inputs at the shape's
    global batch (tokens, labels and a vision prefix over the batch axes,
    ``tokens_pspec``; a decode step's token replicated and its cache by
    ``cache_pspecs``)."""
    B = shape.global_batch
    inputs = input_specs(cfg, shape, B, seq)
    if shape.mode in ("train", "prefill"):
        extra = 2 if cfg.num_codebooks > 1 else 1
        in_specs = {k: tokens_pspec(B, mesh_shape, extra_dims=extra if k != "frontend" else 2)
                    for k in inputs}
    else:
        in_specs = {"token": (), "pos": (),
                    "cache": cache_pspecs(inputs["cache"], mesh_shape, stacked=cfg.scan_layers)}
    p_bytes = sharded_bytes(params, params_pspecs(params, mesh_shape), mesh_shape)
    o_bytes = 0
    if opt_state is not None:
        o_bytes = sharded_bytes(opt_state, opt_state_pspecs(opt_state, params, mesh_shape),
                                mesh_shape)
    i_bytes = sharded_bytes(inputs, in_specs, mesh_shape)
    return {"mesh": dict(mesh_shape), "params_bytes": p_bytes, "opt_state_bytes": o_bytes,
            "input_bytes": i_bytes, "total_bytes": p_bytes + o_bytes + i_bytes}


def dryrun_one(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    optimizer: str = "basis_rotation",
    rotation: Optional[Tuple[str, str]] = None,
    verbose: bool = True,
    overrides: Optional[Dict] = None,
    variant: str = "",
    extrapolate: bool = True,
    microbatches: int = 1,
    use_kernels: bool = False,
    batch: Optional[int] = None,
    seq: Optional[int] = None,
) -> Dict:
    """One row: ``arch`` (its full config with ``overrides``) at
    ``shape_name``, one data replica of the grid on one card. ``batch`` and
    ``seq`` replace the replica's rows and the shape's length (the smoke
    script's reckonings); ``extrapolate=False`` skips the counts."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = INPUT_SHAPES[shape_name]
    if shape.name == "long_500k" and not cfg.supports_long_context():
        row = {
            "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "status": "skipped", "reason": "full attention (DESIGN.md §6)",
        }
        if verbose:
            print(json.dumps(row), flush=True)
        return row
    axes = grid(multi_pod)
    replicas = 1
    for v in axes.values():
        replicas *= v
    rows = batch if batch is not None else replica_batch(shape, replicas)
    S = seq or shape.seq_len
    model, fn, args, held = build_step(cfg, shape, rows, S, optimizer,
                                       rotation or rotation_strategy(arch), microbatches,
                                       use_kernels)
    params = param_leaves(model)
    n_total, n_active = param_counts(params, cfg)
    ref_mesh = {**axes, "model": MODEL_AXIS}
    sharded = sharded_figures(cfg, shape, params, held[1] if shape.mode == "train" else None,
                              ref_mesh, S)
    del params
    res = trace_step(fn, args, held, count=extrapolate)
    del model, fn, args, held

    coll = {}
    if shape.mode == "train" and extrapolate:
        coll = {"all-reduce": int(ring_all_reduce_bytes(4 * n_total, replicas))}
    mf = model_flops(cfg, shape, n_active) / replicas  # per-card MODEL_FLOPS
    peak = res["argument_bytes"] + res["temp_bytes"]
    rf = roofline_from_trace(res["flops"], res["hbm_bytes"], coll, peak, mf,
                             peak_flops_for(cfg.dtype))
    row = {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "variant": variant,
        "status": "ok",
        "mesh": {**axes, "model": 1},
        "reference_mesh": ref_mesh,
        "grid": "one data replica on one card; the reference's model axis folded onto it",
        "mode": shape.mode,
        "batch": rows,
        "seq": S,
        "params_total": n_total,
        "params_active": n_active,
        "compile_s": round(res["trace_s"], 1),
        "extrap_s": 0.0,
        "flops": rf.flops,
        "hbm_bytes": rf.hbm_bytes,
        "collective_bytes": rf.collective_bytes,
        "compute_s": round(rf.compute_s, 6),
        "memory_s": round(rf.memory_s, 6),
        "collective_s": round(rf.collective_s, 6),
        "bottleneck": rf.bottleneck,
        "peak_flops": peak_flops_for(cfg.dtype),
        "model_flops": mf,
        "useful_flops_ratio": round(rf.useful_flops_ratio, 4),
        "collectives": rf.collectives,
        "argument_bytes": res["argument_bytes"],
        "temp_bytes": res["temp_bytes"],
        "output_bytes": res["output_bytes"],
        "peak_bytes_per_device": peak,
        "card_bytes": CARD_BYTES,
        "fits": peak <= CARD_BYTES,
        "sharded": sharded,
    }
    if verbose:
        print(json.dumps(row), flush=True)
    return row


def refuse_sharding_flags(argv) -> None:
    """Exit naming ``--grad-rs`` / ``--seq-shard``: both act on the
    tensor-parallel ``model`` axis at run time. The sharding rules are
    ported (a row's ``sharded`` figures), but the port has no
    tensor-parallel runtime to apply them."""
    for flag in SHARDING_FLAGS:
        if flag in argv:
            raise SystemExit(
                f"{flag} is not supported: it shards the step over the tensor-parallel `model` "
                "axis at run time; the port has the reference's sharding rules "
                "(repro_torch.sharding, each row's \"sharded\" bytes) but no tensor-parallel "
                "runtime to apply them, so a dry-run row's step is one data replica on one card")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    refuse_sharding_flags(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + ["paper_95m", "paper_1b", "paper_3b",
                                                  "phi4_mini_3_8b_swa"], default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--optimizer", default="basis_rotation")
    ap.add_argument("--rotation-source", default=None, choices=["1st", "2nd"])
    ap.add_argument("--rotation-geometry", default=None, choices=["unilateral", "bilateral"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--variant", default="", help="label recorded in the row")
    ap.add_argument("--bf16-logits", action="store_true")
    ap.add_argument("--moe-group", type=int, default=None)
    ap.add_argument("--remat-policy", default=None, choices=["full", "dots"])
    ap.add_argument("--no-extrap", action="store_true",
                    help="memory only (skip the FLOP and byte counts)")
    ap.add_argument("--loss-chunk", type=int, default=None,
                    help="chunked cross-entropy (sequence chunk length)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation microbatches in the train step")
    args = ap.parse_args(argv)

    overrides = {}
    if args.bf16_logits:
        overrides["logits_fp32"] = False
    if args.remat_policy:
        overrides["remat_policy"] = args.remat_policy
    if args.loss_chunk is not None:
        overrides["loss_chunk"] = args.loss_chunk

    rotation = None
    if args.rotation_source and args.rotation_geometry:
        rotation = (args.rotation_source, args.rotation_geometry)

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all) required")
        combos = [(args.arch, args.shape)]

    rows = []
    for a, s in combos:
        try:
            ov = dict(overrides)
            if args.moe_group is not None:
                cfg0 = get_config(a)
                if cfg0.moe is not None:
                    ov["moe"] = dataclasses.replace(cfg0.moe, group_size=args.moe_group)
            row = dryrun_one(a, s, args.multi_pod, args.optimizer, rotation,
                             overrides=ov or None, variant=args.variant,
                             extrapolate=not args.no_extrap, microbatches=args.microbatches)
            rows.append(row)
        except Exception as e:  # noqa: BLE001 — record failures, keep going
            rows.append({"arch": a, "shape": s, "multi_pod": args.multi_pod,
                         "status": "error", "error": f"{type(e).__name__}: {e}"})
            print(json.dumps(rows[-1]), flush=True)
        if args.out:  # write incrementally: long sweeps survive interruption
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rows[-1]) + "\n")
    return rows


if __name__ == "__main__":
    main()
