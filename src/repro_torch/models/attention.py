"""Attention mixers: grouped-query attention and DeepSeek-style MLA
(multi-head latent attention with a compressed KV cache), each with a
training path and single-token decode. Port of ``repro/models/attention.py``
(``init_attention``, ``gqa_train``, ``init_gqa_cache``, ``gqa_decode``,
``_mla_queries``, ``_mla_latent``, ``mla_train``, ``init_mla_cache``,
``mla_decode``).

GQA has the optional query/key/value biases (``qkv_bias``: ``b_q``,
``b_k``, ``b_v``, added before the head reshape) and per-head RMS norm of
queries and keys (``qk_norm``: ``q_norm``, ``k_norm``, applied after the
reshape and before RoPE). Without kernels, scores are materialised (B, H,
S, S) and the softmax runs in float32 with masked entries filled with
``NEG_INF``. ``use_kernels`` routes GQA to the flash-attention kernels
(B1-B3, ``_attn_flash``), which never materialise the scores; it does not
reach MLA, as in the reference (``repro/models/transformer.py:52-54``).

MLA compresses keys and values into a latent of ``kv_lora_rank`` per token
(normed, then expanded by ``kv_b`` into per-head keys and values) beside
one shared RoPE key of ``qk_rope_head_dim``; queries come through an
optional low-rank ``q_a``/``q_b`` pair (``q_lora_rank > 0``) or ``w_q``.
Its decode caches the latent (B, S_max, kv_lora_rank) and the roped key
(B, S_max, dr) and runs the "absorbed" form: the key up-projection is
folded into the query and attention runs in the latent space, so no
per-head K or V is expanded.

Above ``CHUNKED_ATTN_THRESHOLD`` tokens, when S divides into blocks of
``QUERY_BLOCK``, the no-kernel GQA path and MLA stream the queries in
blocks, as the reference does: each block's (B, H, QUERY_BLOCK, S) scores
are formed under ``torch.utils.checkpoint`` (non-reentrant, the reference's
``jax.checkpoint`` of its scan body), so the forward keeps only each
block's output and the backward recomputes one block's scores at a time.
With ``use_kernels`` GQA keeps taking the flash kernels at every length.

The functions take the mixer's weights as a ``{name: tensor}`` dict (the
reference's parameter dict), so that the decode path can run them on
compute-dtype copies of the masters. Decode writes the new token into its
cache in place.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import AttentionConfig
from repro_torch.models.layers import apply_rope, dense_init, param, rms_norm_headwise

Tensor = torch.Tensor

NEG_INF = -1e30
# above this sequence length the (S x S) scores are not formed whole: the
# queries stream in blocks of QUERY_BLOCK (when S divides into them)
CHUNKED_ATTN_THRESHOLD = 8192
QUERY_BLOCK = 2048


def _query_chunked(S: int) -> bool:
    return S > CHUNKED_ATTN_THRESHOLD and S % QUERY_BLOCK == 0


def _by_query_blocks(block, *qs: Tensor) -> Tensor:
    """``block(*q_blocks, offset)`` over consecutive query blocks of the
    (B, H, S, .) tensors ``qs``, concatenated along S. Under autograd each
    block runs checkpointed: only its output is kept, and its scores are
    recomputed in the backward."""
    S = qs[0].shape[2]
    outs = []
    for start in range(0, S, QUERY_BLOCK):
        args = [q[:, :, start: start + QUERY_BLOCK] for q in qs]
        if torch.is_grad_enabled():
            outs.append(checkpoint(block, *args, start, use_reentrant=False))
        else:
            outs.append(block(*args, start))
    return torch.cat(outs, dim=2)


class Attention(nn.Module):
    def __init__(self, d_model: int, cfg: AttentionConfig, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.cfg = cfg
        if cfg.kind == "mla":
            self._init_mla(d_model, cfg, dtype, device, generator)
            return
        if cfg.kind != "gqa":
            raise ValueError(f"unknown attention kind {cfg.kind!r}")
        H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.w_q = param(dense_init((d_model, H * dh), generator), dtype, device)
        self.w_k = param(dense_init((d_model, Hkv * dh), generator), dtype, device)
        self.w_v = param(dense_init((d_model, Hkv * dh), generator), dtype, device)
        self.w_o = param(dense_init((H * dh, d_model), generator), dtype, device)
        if cfg.qkv_bias:
            self.b_q = param(torch.zeros(H * dh), dtype, device)
            self.b_k = param(torch.zeros(Hkv * dh), dtype, device)
            self.b_v = param(torch.zeros(Hkv * dh), dtype, device)
        if cfg.qk_norm:
            self.q_norm = param(torch.ones(dh), dtype, device)
            self.k_norm = param(torch.ones(dh), dtype, device)

    def _init_mla(self, d_model: int, cfg: AttentionConfig, dtype, device,
                  generator: Optional[torch.Generator]) -> None:
        """MLA's leaves: ``kv_a`` (d, r + dr), ``kv_a_norm`` (r), ``kv_b``
        (r, H (dn + dv)), ``w_o`` (H dv, d), and ``q_a`` (d, q_lora_rank),
        ``q_a_norm``, ``q_b`` (q_lora_rank, H (dn + dr)) or ``w_q`` (d, H
        (dn + dr))."""
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        H, r = cfg.num_heads, cfg.kv_lora_rank
        self.kv_a = param(dense_init((d_model, r + dr), generator), dtype, device)
        self.kv_b = param(dense_init((r, H * (dn + dv)), generator), dtype, device)
        self.w_o = param(dense_init((H * dv, d_model), generator), dtype, device)
        self.kv_a_norm = param(torch.ones(r), dtype, device)
        if cfg.q_lora_rank > 0:
            self.q_a = param(dense_init((d_model, cfg.q_lora_rank), generator), dtype, device)
            self.q_b = param(dense_init((cfg.q_lora_rank, H * (dn + dr)), generator), dtype,
                             device)
            self.q_a_norm = param(torch.ones(cfg.q_lora_rank), dtype, device)
        else:
            self.w_q = param(dense_init((d_model, H * (dn + dr)), generator), dtype, device)

    def forward(self, x: Tensor, use_kernels: bool = False) -> Tensor:
        w = dict(self.named_parameters())
        if self.cfg.kind == "mla":
            return mla_train(w, x, self.cfg)
        return gqa_train(w, x, self.cfg, use_kernels)


def _project_qkv(w: Mapping[str, Tensor], x: Tensor, cfg: AttentionConfig):
    B, S, _ = x.shape
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ w["w_q"], x @ w["w_k"], x @ w["w_v"]
    if cfg.qkv_bias:
        q, k, v = q + w["b_q"], k + w["b_k"], v + w["b_v"]
    q = q.reshape(B, S, H, dh).transpose(1, 2)
    k = k.reshape(B, S, Hkv, dh).transpose(1, 2)
    v = v.reshape(B, S, Hkv, dh).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, w["q_norm"])
        k = rms_norm_headwise(k, w["k_norm"])
    return q, k, v


def _gqa_scores(q: Tensor, k: Tensor, groups: int) -> Tensor:
    """q: (B,H,Sq,dh), k: (B,Hkv,Sk,dh) -> (B,H,Sq,Sk) with KV grouping."""
    B, H, Sq, dh = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, groups, Sq, dh)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k)
    return s.reshape(B, H, Sq, k.shape[2])


def _gqa_mix(w: Tensor, v: Tensor, groups: int) -> Tensor:
    B, H, Sq, Sk = w.shape
    Hkv = v.shape[1]
    wg = w.reshape(B, Hkv, groups, Sq, Sk)
    o = torch.einsum("bkgqs,bksd->bkgqd", wg, v)
    return o.reshape(B, H, Sq, v.shape[3])


def _attn_flash(q: Tensor, k: Tensor, v: Tensor, cfg: AttentionConfig) -> Tensor:
    """Flash attention through the CUDA kernels (their plain versions on the
    CPU). The kernels are plain multi-head attention over (B*H) heads, so
    grouped KV heads are repeated to full heads first, as in the reference."""
    from repro_torch.kernels.flash import flash_attention

    if cfg.kv_groups > 1:
        k = torch.repeat_interleave(k, cfg.kv_groups, dim=1)
        v = torch.repeat_interleave(v, cfg.kv_groups, dim=1)
    return flash_attention(q, k, v, causal=True, window=cfg.window)


def _attn_dense(q: Tensor, k: Tensor, v: Tensor, cfg: AttentionConfig,
                q_offset: int, S_kv: int) -> Tensor:
    """Causal (optionally windowed) attention for one query block."""
    Sq = q.shape[2]
    scores = _gqa_scores(q, k, cfg.kv_groups) / math.sqrt(cfg.head_dim)
    i = q_offset + torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(S_kv, device=q.device)[None, :]
    mask = j <= i
    if cfg.window is not None:
        mask &= j > i - cfg.window
    scores = scores.float().masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_mix(w, v, cfg.kv_groups)


def gqa_train(w: Mapping[str, Tensor], x: Tensor, cfg: AttentionConfig,
              use_kernels: bool = False) -> Tensor:
    B, S, _ = x.shape
    q, k, v = _project_qkv(w, x, cfg)
    positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if use_kernels:
        o = _attn_flash(q, k, v, cfg)
    elif _query_chunked(S):
        o = _by_query_blocks(lambda qb, offset: _attn_dense(qb, k, v, cfg, offset, S), q)
    else:
        o = _attn_dense(q, k, v, cfg, 0, S)
    o = o.transpose(1, 2).reshape(B, S, -1)
    return o @ w["w_o"]


def init_gqa_cache(batch: int, seq_len: int, cfg: AttentionConfig, dtype,
                   device) -> Dict[str, Tensor]:
    """Zeroed K and V caches (B, Hkv, slots, dh): a ring of ``window`` slots
    when the config has a window, else ``seq_len`` slots."""
    size = cfg.window if cfg.window is not None else seq_len
    shape = (batch, cfg.num_kv_heads, size, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(w: Mapping[str, Tensor], x: Tensor, cache: Dict[str, Tensor], pos: int,
               cfg: AttentionConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, 1, d_model); ``pos`` the new token's index. Writes its key and
    value into ``cache`` in place (the reference returns an updated copy)
    and returns (output (B, 1, d_model), cache)."""
    B = x.shape[0]
    q, k, v = _project_qkv(w, x, cfg)  # (B,H,1,dh) / (B,Hkv,1,dh)
    at = torch.tensor([pos], device=x.device)
    q = apply_rope(q, at, cfg.rope_theta)
    k = apply_rope(k, at, cfg.rope_theta)

    size = cache["k"].shape[2]
    slot = pos % size if cfg.window is not None else pos
    cache["k"][:, :, slot] = k[:, :, 0]
    cache["v"][:, :, slot] = v[:, :, 0]

    scores = _gqa_scores(q, cache["k"], cfg.kv_groups) / math.sqrt(cfg.head_dim)
    idx = torch.arange(size, device=x.device)
    if cfg.window is not None:
        # slots hold tokens (pos - size, pos]; invalid until written
        age = (slot - idx) % size
        valid = age <= min(pos, size - 1)
    else:
        valid = idx <= pos
    scores = scores.float().masked_fill(~valid, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(x.dtype)
    o = _gqa_mix(p, cache["v"], cfg.kv_groups)
    o = o.transpose(1, 2).reshape(B, 1, -1)
    return o @ w["w_o"], cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------


def _mla_queries(w: Mapping[str, Tensor], x: Tensor, cfg: AttentionConfig):
    """(q_nope (B, H, S, dn), q_rope (B, H, S, dr)), RoPE not yet applied."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if "q_a" in w:
        cq = rms_norm_headwise(x @ w["q_a"], w["q_a_norm"])
        q = cq @ w["q_b"]
    else:
        q = x @ w["w_q"]
    q = q.reshape(B, S, cfg.num_heads, dn + dr).transpose(1, 2)
    return q[..., :dn], q[..., dn:]


def _mla_latent(w: Mapping[str, Tensor], x: Tensor, cfg: AttentionConfig):
    """(normed latent (B, S, r), shared rope key (B, S, dr)), RoPE not yet
    applied."""
    ckv = x @ w["kv_a"]
    latent, k_rope = ckv[..., : cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    return rms_norm_headwise(latent, w["kv_a_norm"]), k_rope


def mla_train(w: Mapping[str, Tensor], x: Tensor, cfg: AttentionConfig) -> Tensor:
    """Causal MLA over the whole sequence, the per-head keys and values
    expanded from the latent; scores (B, H, S, S), or (B, H, QUERY_BLOCK, S)
    a query block above the threshold, softmax in float32."""
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    positions = torch.arange(S, device=x.device)

    q_nope, q_rope = _mla_queries(w, x, cfg)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    latent, k_rope = _mla_latent(w, x, cfg)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)  # (B, S, dr), shared by the heads

    kv = (latent @ w["kv_b"]).reshape(B, S, H, dn + dv).transpose(1, 2)
    k_nope, v = kv[..., :dn], kv[..., dn:]

    scale = 1.0 / math.sqrt(dn + dr)

    def block(q_n: Tensor, q_r: Tensor, offset: int) -> Tensor:
        scores = (torch.einsum("bhqd,bhsd->bhqs", q_n, k_nope)
                  + torch.einsum("bhqd,bsd->bhqs", q_r, k_rope)) * scale
        i = offset + torch.arange(q_n.shape[2], device=x.device)[:, None]
        j = torch.arange(S, device=x.device)[None, :]
        scores = scores.float().masked_fill(j > i, NEG_INF)
        p = torch.softmax(scores, dim=-1).to(x.dtype)
        return torch.einsum("bhqs,bhsd->bhqd", p, v)

    if _query_chunked(S):
        o = _by_query_blocks(block, q_nope, q_rope)
    else:
        o = block(q_nope, q_rope, 0)
    o = o.transpose(1, 2).reshape(B, S, H * dv)
    return o @ w["w_o"]


def init_mla_cache(batch: int, seq_len: int, cfg: AttentionConfig, dtype,
                   device) -> Dict[str, Tensor]:
    """Zeroed latent (B, seq_len, kv_lora_rank) and roped-key (B, seq_len,
    qk_rope_head_dim) caches."""
    return {"latent": torch.zeros((batch, seq_len, cfg.kv_lora_rank), dtype=dtype,
                                  device=device),
            "k_rope": torch.zeros((batch, seq_len, cfg.qk_rope_head_dim), dtype=dtype,
                                  device=device)}


def mla_decode(w: Mapping[str, Tensor], x: Tensor, cache: Dict[str, Tensor], pos: int,
               cfg: AttentionConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Absorbed MLA decode: attention runs in the compressed latent space.
    x: (B, 1, d_model); ``pos`` the new token's index. Writes its latent and
    roped key into ``cache`` in place and returns (output (B, 1, d_model),
    cache)."""
    B = x.shape[0]
    H, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    at = torch.tensor([pos], device=x.device)

    q_nope, q_rope = _mla_queries(w, x, cfg)  # (B, H, 1, dn / dr)
    q_rope = apply_rope(q_rope, at, cfg.rope_theta)
    latent_t, k_rope_t = _mla_latent(w, x, cfg)  # (B, 1, r), (B, 1, dr)
    cache["latent"][:, pos] = latent_t[:, 0]
    cache["k_rope"][:, pos] = apply_rope(k_rope_t, at, cfg.rope_theta)[:, 0]
    latent, k_rope = cache["latent"], cache["k_rope"]

    kv_b = w["kv_b"].reshape(r, H, dn + dv)
    w_uk, w_uv = kv_b[..., :dn], kv_b[..., dn:]  # (r, H, dn), (r, H, dv)
    q_abs = torch.einsum("bhqd,rhd->bhqr", q_nope, w_uk)  # the key up-projection absorbed

    scale = 1.0 / math.sqrt(dn + dr)
    scores = (torch.einsum("bhqr,bsr->bhqs", q_abs, latent)
              + torch.einsum("bhqd,bsd->bhqs", q_rope, k_rope)) * scale
    valid = torch.arange(latent.shape[1], device=x.device) <= pos
    scores = scores.float().masked_fill(~valid, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhqs,bsr->bhqr", p, latent)  # (B, H, 1, r)
    o = torch.einsum("bhqr,rhd->bhqd", o_lat, w_uv)  # (B, H, 1, dv)
    o = o.transpose(1, 2).reshape(B, 1, H * dv)
    return o @ w["w_o"], cache
