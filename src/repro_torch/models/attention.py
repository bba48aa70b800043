"""Grouped-query attention: the training path and single-token decode.
Port of the GQA half of ``repro/models/attention.py`` (``gqa_train``,
``init_gqa_cache``, ``gqa_decode``), with the optional query/key/value
biases (``qkv_bias``: ``b_q``, ``b_k``, ``b_v``, added before the head
reshape) and per-head RMS norm of queries and keys (``qk_norm``:
``q_norm``, ``k_norm``, applied after the reshape and before RoPE).

Without kernels, scores are materialised (B, H, S, S) and the softmax runs
in float32 with masked entries filled with ``NEG_INF``. ``use_kernels``
routes attention to the flash-attention kernels (B1-B3, ``_attn_flash``),
which never materialise the scores. The reference streams queries in blocks
above ``CHUNKED_ATTN_THRESHOLD``; that branch is not ported yet and raises,
as does MLA attention.

The functions take the mixer's weights as a ``{name: tensor}`` dict (the
reference's parameter dict), so that the decode path can run them on
compute-dtype copies of the masters.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import AttentionConfig
from repro_torch.models.layers import apply_rope, dense_init, param, rms_norm_headwise

Tensor = torch.Tensor

NEG_INF = -1e30
CHUNKED_ATTN_THRESHOLD = 8192
QUERY_BLOCK = 2048


class Attention(nn.Module):
    def __init__(self, d_model: int, cfg: AttentionConfig, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        if cfg.kind != "gqa":
            raise NotImplementedError(f"not yet ported: MLA attention (kind={cfg.kind!r})")
        H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.cfg = cfg
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

    def forward(self, x: Tensor, use_kernels: bool = False) -> Tensor:
        return gqa_train(dict(self.named_parameters()), x, self.cfg, use_kernels)


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
    if not use_kernels and S > CHUNKED_ATTN_THRESHOLD and S % QUERY_BLOCK == 0:
        raise NotImplementedError("not yet ported: query-chunked attention")
    q, k, v = _project_qkv(w, x, cfg)
    positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = _attn_flash(q, k, v, cfg) if use_kernels else _attn_dense(q, k, v, cfg, 0, S)
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
