"""Whole-model API: init, training forward and loss, and single-token decode.
Port of ``repro/models/model.py``: GQA and MLA attention, Mamba, mLSTM and
sLSTM blocks with dense, MoE or no MLPs, in a pattern of mixed kinds (layer
l is ``cfg.pattern[l % len(cfg.pattern)]``).

Two parameter layouts, as in the reference. ``scan_layers=False`` keeps one
subtree per layer (``blocks/<layer>/...``). ``scan_layers=True`` keeps one
set of leaves per pattern position, stacked over the ``num_superblocks``
superblocks on a leading axis (``blocks/<position>/...`` of shape
``(num_superblocks, ...)``, the reference's stacked tree). The stacked
forward runs superblock after superblock, each under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its scan
body): only the (B, S, d) boundaries are kept, and ``remat_policy="dots"``
also keeps the blocks' matrix products (``_DOTS``, the counterpart of
``dots_with_no_batch_dims_saveable``). The stacked weights are drawn layer
by layer in the per-layer model's order, so a seed gives both layouts the
same weights. ``loss_chunk > 0`` takes the head and cross-entropy over
sequence chunks (``_chunked_ce``), each checkpointed, so the (B, S, V)
logits are never formed.

The modality frontends are stubs, as in the reference: the batch carries
precomputed embeddings (``batch["frontend"]``, (B, P, frontend_dim)),
which ``frontend_proj`` maps into d_model and which run as a prefix before
the text; the logits cover the text positions only. With ``K =
cfg.num_codebooks > 1`` tokens are (B, S, K): the embedding (K, V, d) sums
the codebooks' rows and the head (d, K V) gives (B, S, K, V) logits.
``embed`` and ``head_logits`` (the reference's
``_embed`` and ``_logits`` with the final norm) take the shared weights as a
``{path: tensor}`` dict, so that the SPMD schedules run the same code on
their own copies of those weights.

The module tree mirrors the reference's parameter tree, so that
``named_parameters`` names map onto its leaf paths (``blocks/3/mixer/w_q``,
``blocks/0/mlp/w_gate_e``, ``embed/embedding``, ``lm_head``, ``pos_emb``,
``frontend_proj``, ``final_norm/scale``).
Parameters are float32 masters. Where the compute dtype differs from them
(the catalog's bfloat16 configs, the ``bf16`` precision policy),
``forward_train``, ``forward_decode`` and the SPMD schedules run on
compute-dtype copies made by ``cast_params``, as the reference casts its
masters at use.
Weights are drawn from an explicit CPU ``torch.Generator`` and then moved to
the device, so a seed gives the same weights on every device; they do not
reproduce ``jax.random`` (the tests carry weights across with
``repro_torch.checkpoint.convert``). ``draw_device="cuda"`` draws them on
the card instead, from a generator of its own: other weights for the same
seed, in a fraction of the host's time at billions of parameters.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig, SSMConfig
from repro_torch.core.layout import path_str, tree_order_key
from repro_torch.models.layers import Norm, apply_norm, dense_init, embed_init, param
from repro_torch.models.transformer import Block, block_decode, init_block_cache

Tensor = torch.Tensor

IGNORE_INDEX = -100

REMAT_POLICIES = ("full", "dots")
# the matrix products without batch dimensions (``x @ W`` of a projection,
# which reaches the dispatcher as mm); the attention's batched einsums are bmm
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class Embedding(nn.Module):
    def __init__(self, shape: Tuple[int, ...], dtype, device, generator):
        super().__init__()
        self.embedding = param(embed_init(shape, generator), dtype, device)


def _stacked_blocks(cfg: ModelConfig, device, gen: Optional[torch.Generator]) -> List[Block]:
    """One block per pattern position whose every leaf has a leading axis
    of ``num_superblocks``. Each layer is drawn as the per-layer model draws
    it, in layer order, and copied into its slot; without a generator the
    leaves stay uninitialised."""
    n, P = cfg.num_superblocks, len(cfg.pattern)
    blocks = [Block(cfg, spec, "meta", None) for spec in cfg.pattern]
    for blk in blocks:
        for mod in blk.modules():
            for name, p in list(mod.named_parameters(recurse=False)):
                setattr(mod, name, nn.Parameter(
                    torch.empty((n,) + tuple(p.shape), dtype=p.dtype, device=device)))
    if gen is not None:
        with torch.no_grad():
            for l in range(cfg.num_layers):
                one = Block(cfg, cfg.pattern[l % P], device, gen)
                dst = dict(blocks[l % P].named_parameters())
                for name, w in one.named_parameters():
                    dst[name][l // P].copy_(w)
    return blocks


class Transformer(nn.Module):
    """Decoder-only transformer, per-layer or stacked (``cfg.scan_layers``).
    ``seed=None`` leaves the weights uninitialised, for callers that load
    them; ``draw_device`` is where the seed's generator draws them (the CPU
    by default)."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str = "cuda",
                 seed: Optional[int] = 0, draw_device: torch.device | str = "cpu"):
        super().__init__()
        if cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} (have {REMAT_POLICIES})")
        gen = None if seed is None else torch.Generator(draw_device).manual_seed(seed)
        dtype = cfg.params_dtype
        self.cfg = cfg
        V, d, K = cfg.vocab_size, cfg.d_model, cfg.num_codebooks
        if K > 1:
            self.embed = Embedding((K, V, d), dtype, device, gen)
            self.lm_head = param(dense_init((d, K * V), gen), dtype, device)
        else:
            self.embed = Embedding((V, d), dtype, device, gen)
            if not cfg.tie_embeddings:
                self.lm_head = param(dense_init((d, V), gen), dtype, device)
        if cfg.learnable_pos_emb:
            self.pos_emb = param(embed_init((cfg.max_seq_len, d), gen), dtype, device)
        if cfg.frontend is not None and cfg.frontend_dim:
            self.frontend_proj = param(dense_init((cfg.frontend_dim, d), gen), dtype, device)
        if cfg.scan_layers:
            self.blocks = nn.ModuleList(_stacked_blocks(cfg, device, gen))
        else:
            self.blocks = nn.ModuleList(
                Block(cfg, cfg.pattern[l % len(cfg.pattern)], device, gen)
                for l in range(cfg.num_layers)
            )
        self.final_norm = Norm(cfg.norm, d, dtype, device)

    def forward(self, tokens: Tensor, frontend_embeds: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
        return forward_train(self, tokens, frontend_embeds)


def init_model(cfg: ModelConfig, seed: int = 0, device: torch.device | str = "cuda") -> Transformer:
    return Transformer(cfg, device=device, seed=seed)


def use_config(model: Transformer, cfg: ModelConfig) -> Transformer:
    """Point a built model and its modules at ``cfg``, a config of the same
    leaves that differs in what runs (the compute dtype, the MoE's capacity
    factor, the remat policy), so that one draw of the weights serves
    several runs. The model keeps its own layout: ``cfg.scan_layers`` is
    replaced by the model's. Returns the model."""
    cfg = cfg.replace(scan_layers=model.cfg.scan_layers)
    want = {k: tuple(p.shape) for k, p in
            param_leaves(Transformer(cfg, "meta", None)).items()}
    have = {k: tuple(p.shape) for k, p in param_leaves(model).items()}
    if want != have:
        raise ValueError(f"{cfg.name}: its leaves differ from the model's")
    parts = {AttentionConfig: cfg.attention, MoEConfig: cfg.moe, SSMConfig: cfg.ssm}
    for m in model.modules():
        if isinstance(m, (Transformer, Block)):
            m.cfg = cfg
        elif type(getattr(m, "cfg", None)) in parts:
            m.cfg = parts[type(m.cfg)]
    return model


def param_leaves(model: nn.Module) -> Dict[str, nn.Parameter]:
    """``{path: parameter}`` in the reference's ``tree_flatten`` leaf order."""
    named = {path_str(n): p for n, p in model.named_parameters()}
    return {k: named[k] for k in sorted(named, key=tree_order_key)}


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def cast_params(params: Mapping[str, Tensor], dtype: torch.dtype) -> Dict[str, Tensor]:
    """Mixed precision: float32 master weights -> compute-dtype copies at use.
    Floating leaves go to ``dtype``, other leaves pass through; a leaf already
    in ``dtype`` is returned as it is. The autograd of ``.to()`` hands each
    master a float32 gradient."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}


def shared_leaves(model: Transformer) -> Dict[str, Tensor]:
    """The weights outside the blocks, ``{path: parameter}`` in leaf order."""
    return {k: p for k, p in param_leaves(model).items() if not k.startswith("blocks/")}


def embed(shared: Mapping[str, Tensor], cfg: ModelConfig, tokens: Tensor,
          start: int = 0, frontend_embeds: Optional[Tensor] = None) -> Tensor:
    """Token embedding of (..., S) tokens, or (..., S, K) with K codebooks
    (their rows summed), after the projected frontend prefix (B, P,
    frontend_dim) when one is given; then the learnable position embedding
    of positions start .. start + P + S - 1."""
    emb = shared["embed/embedding"]
    if cfg.num_codebooks > 1:
        x = sum(emb[k][tokens[..., k]] for k in range(cfg.num_codebooks))
    else:
        x = emb[tokens]
    x = x.to(cfg.compute_dtype)
    if frontend_embeds is not None:
        pref = frontend_embeds.to(cfg.compute_dtype)
        if "frontend_proj" in shared:
            pref = pref @ shared["frontend_proj"]
        x = torch.cat([pref, x], dim=1)
    if cfg.learnable_pos_emb:
        x = x + shared["pos_emb"][start: start + x.shape[-2]].to(x.dtype)
    return x


def head_logits(shared: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor) -> Tensor:
    """Final norm, then the LM head (float32 logits unless told otherwise):
    (..., V), or (..., K, V) with K codebooks."""
    return logits_from_features(shared, cfg, final_norm(shared, x))


def final_norm(shared: Mapping[str, Tensor], x: Tensor) -> Tensor:
    return apply_norm(shared["final_norm/scale"], shared.get("final_norm/bias"), x)


def logits_from_features(shared: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor) -> Tensor:
    """The LM head on final-norm hidden states."""
    dt = torch.float32 if cfg.logits_fp32 else cfg.compute_dtype
    if cfg.num_codebooks > 1:
        out = x.to(dt) @ shared["lm_head"].to(dt)
        return out.reshape(*x.shape[:-1], cfg.num_codebooks, cfg.vocab_size)
    head = shared["embed/embedding"].T if cfg.tie_embeddings else shared["lm_head"]
    return x.to(dt) @ head.to(dt)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _superblock(blocks: Sequence[Block], x: Tensor, *weights: Tensor) -> Tuple[Tensor, Tensor]:
    """One superblock: the pattern's blocks in order, each on its slice of
    the stacked leaves (``weights``: the blocks' leaves, in order)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    it = iter(weights)
    for blk in blocks:
        names = [n for n, _ in blk.named_parameters()]
        x, a = functional_call(blk, dict(zip(names, it)), (x,))
        aux = aux + a
    return x, aux


def _run_stacked(model: Transformer, x: Tensor, dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """The stacked layers, superblock after superblock, each checkpointed
    under the config's remat policy when autograd records. The stacked
    leaves are cast (when the compute dtype differs) and unbound once, so
    each leaf's gradient is stacked once from its superblocks' slices."""
    cfg = model.cfg
    slices = [w.unbind(0) for blk in model.blocks
              for w in cast_params(dict(blk.named_parameters()), dtype).values()]
    run = functools.partial(_superblock, list(model.blocks))
    kw = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_superblocks):
        ws = [s[i] for s in slices]
        if torch.is_grad_enabled():
            x, a = checkpoint(run, x, *ws, **kw)
        else:
            x, a = run(x, *ws)
        aux = aux + a
    return x, aux


def _features(model: Transformer, shared: Mapping[str, Tensor], tokens: Tensor,
              frontend_embeds: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """Hidden states after the last block (before the final norm) over the
    text positions, and the auxiliary loss."""
    cfg = model.cfg
    dtype = cfg.compute_dtype
    x = embed(shared, cfg, tokens, frontend_embeds=frontend_embeds)
    if cfg.scan_layers:
        x, aux = _run_stacked(model, x, dtype)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in model.blocks:
            if dtype == cfg.params_dtype:
                x, a = block(x)
            else:  # the block on compute-dtype copies of its masters
                x, a = functional_call(block, cast_params(dict(block.named_parameters()),
                                                          dtype), (x,))
            aux = aux + a
    if frontend_embeds is not None:
        x = x[:, frontend_embeds.shape[1]:]  # logits over the text positions only
    return x, aux


def forward_features(model: Transformer, tokens: Tensor,
                     frontend_embeds: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Final-norm hidden states (before the LM head) over the text
    positions, and the auxiliary loss."""
    shared = cast_params(shared_leaves(model), model.cfg.compute_dtype)
    x, aux = _features(model, shared, tokens, frontend_embeds)
    return final_norm(shared, x), aux


def forward_train(model: Transformer, tokens: Tensor,
                  frontend_embeds: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Returns (logits, aux_loss). tokens: (B, S) int64, or (B, S, K) with
    K codebooks; ``frontend_embeds`` (B, P, frontend_dim) run as a prefix,
    and the logits cover the S text positions only."""
    shared = cast_params(shared_leaves(model), model.cfg.compute_dtype)
    x, aux = _features(model, shared, tokens, frontend_embeds)
    return head_logits(shared, model.cfg, x), aux


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: torch.device | str = "cuda") -> Tuple[Dict[str, Tensor], ...]:
    """A zeroed decode cache in the compute dtype unless said: the K/V cache
    of a GQA block, the latent and roped-key caches of an MLA block, the
    recurrent state of a Mamba block (the convolution's last inputs; the SSM
    state float32), an mLSTM block (float32) or an sLSTM block (its h in the
    compute dtype, the rest float32). One per layer, or with
    ``cfg.scan_layers`` one per pattern position, each tensor stacked over
    the superblocks on a leading axis (the layout of ``params["blocks"]``)."""
    if not cfg.scan_layers:
        return tuple(init_block_cache(cfg, cfg.pattern[l % len(cfg.pattern)], batch, seq_len,
                                      cfg.compute_dtype, device)
                     for l in range(cfg.num_layers))
    n = cfg.num_superblocks
    out = []
    for spec in cfg.pattern:
        one = init_block_cache(cfg, spec, batch, seq_len, cfg.compute_dtype, device)
        out.append({k: v.expand((n,) + tuple(v.shape)).clone() for k, v in one.items()})
    return tuple(out)


def forward_decode(model: Transformer, token: Tensor, cache: Tuple[Dict[str, Tensor], ...],
                   pos: int) -> Tuple[Tensor, Tuple[Dict[str, Tensor], ...]]:
    """token: (B, 1) int64 at position ``pos``, or (B, 1, K) with K
    codebooks. Returns (logits (B, 1, V) or (B, 1, K, V), cache): the
    attention caches written in place, the recurrent states new (a stacked
    cache takes each layer's new state into its slot, in place).
    Runs on compute-dtype copies of the masters, as the reference casts
    them at use."""
    cfg = model.cfg
    params = cast_params(param_leaves(model), cfg.compute_dtype)
    groups: List[Dict[str, Tensor]] = [{} for _ in model.blocks]
    shared = {}
    for path, w in params.items():
        if path.startswith("blocks/"):
            _, l, name = path.split("/", 2)
            groups[int(l)][name] = w
        else:
            shared[path] = w
    x = embed(shared, cfg, token, start=pos)
    if not cfg.scan_layers:
        new_cache = []
        for l, (w, c) in enumerate(zip(groups, cache)):
            x, c = block_decode(w, x, c, pos, cfg, cfg.pattern[l % len(cfg.pattern)])
            new_cache.append(c)
        return head_logits(shared, cfg, x), tuple(new_cache)
    for i in range(cfg.num_superblocks):
        for spec, w, c in zip(cfg.pattern, groups, cache):
            view = {k: v[i] for k, v in c.items()}
            x, new = block_decode({n: t[i] for n, t in w.items()}, x, view, pos, cfg, spec)
            for k, v in new.items():
                if v is not view[k]:
                    c[k][i].copy_(v)
    return head_logits(shared, cfg, x), cache


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean CE over non-ignored positions. logits: (..., V), labels: (...)."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)


def _chunked_ce(shared: Mapping[str, Tensor], cfg: ModelConfig, x: Tensor,
                labels: Tensor) -> Tensor:
    """Mean CE over sequence chunks of ``cfg.loss_chunk``: the (B, S, V)
    logits are never formed. Each chunk's head and CE run checkpointed, so
    the backward holds one (B, chunk, V) block at a time; the tail shorter
    than a chunk is summed as the reference sums it (its mean CE times its
    valid count, at least one). ``x``: final-norm hidden states."""
    S = x.shape[1]
    chunk = cfg.loss_chunk
    n = S // chunk

    def body(xb: Tensor, lb: Tensor) -> Tuple[Tensor, Tensor]:
        logits = logits_from_features(shared, cfg, xb)
        valid = lb != IGNORE_INDEX
        safe = torch.where(valid, lb, torch.zeros_like(lb))
        logp = F.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        return torch.sum(torch.where(valid, nll, torch.zeros_like(nll))), torch.sum(valid)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for c in range(n):
        args = (x[:, c * chunk: (c + 1) * chunk], labels[:, c * chunk: (c + 1) * chunk])
        if torch.is_grad_enabled():
            s, k = checkpoint(body, *args, use_reentrant=False)
        else:
            s, k = body(*args)
        tot, cnt = tot + s, cnt + k
    if S - n * chunk:  # the tail chunk
        lt = labels[:, n * chunk:]
        tail = cross_entropy(logits_from_features(shared, cfg, x[:, n * chunk:]), lt)
        nv = torch.sum(lt != IGNORE_INDEX)
        tot = tot + tail * torch.clamp(nv, min=1)
        cnt = cnt + nv
    return tot / torch.clamp(cnt, min=1)


def loss_fn(model: Transformer, batch: Dict[str, Tensor]) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Cross-entropy plus the MoE auxiliary loss; the batch's ``frontend``
    prefix, if any, runs before its tokens. With ``loss_chunk > 0``, one
    codebook and (B, S) tokens of S >= 2 ``loss_chunk``, the CE is chunked."""
    cfg = model.cfg
    tokens, labels = batch["tokens"], batch["labels"]
    if (cfg.loss_chunk > 0 and cfg.num_codebooks == 1 and tokens.ndim == 2
            and tokens.shape[1] >= 2 * cfg.loss_chunk):
        shared = cast_params(shared_leaves(model), cfg.compute_dtype)
        x, aux = _features(model, shared, tokens, batch.get("frontend"))
        ce = _chunked_ce(shared, cfg, final_norm(shared, x), labels)
    else:
        logits, aux = forward_train(model, tokens, batch.get("frontend"))
        ce = cross_entropy(logits, labels)
    return ce + aux, {"ce": ce, "aux": aux}
