"""Grouped-query attention, training path. Port of the dense branch of
``repro/models/attention.py::gqa_train``.

Without kernels, scores are materialised (B, H, S, S) and the softmax runs
in float32 with masked entries filled with ``NEG_INF``. ``use_kernels``
routes attention to the flash-attention kernels (B1-B3, ``_attn_flash``),
which never materialise the scores. The reference streams queries in blocks
above ``CHUNKED_ATTN_THRESHOLD``; that branch is not ported yet and raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import AttentionConfig
from repro_torch.models.layers import apply_rope, dense_init, param

Tensor = torch.Tensor

NEG_INF = -1e30
CHUNKED_ATTN_THRESHOLD = 8192
QUERY_BLOCK = 2048


class Attention(nn.Module):
    def __init__(self, d_model: int, cfg: AttentionConfig, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        if cfg.kind != "gqa" or cfg.qk_norm or cfg.qkv_bias:
            raise NotImplementedError(
                "not yet ported: MLA, qk_norm and qkv_bias attention"
            )
        H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.w_q = param(dense_init((d_model, H * dh), generator), dtype, device)
        self.w_k = param(dense_init((d_model, Hkv * dh), generator), dtype, device)
        self.w_v = param(dense_init((d_model, Hkv * dh), generator), dtype, device)
        self.w_o = param(dense_init((H * dh, d_model), generator), dtype, device)

    def forward(self, x: Tensor, use_kernels: bool = False) -> Tensor:
        return gqa_train(self, x, self.cfg, use_kernels)


def _project_qkv(p: Attention, x: Tensor, cfg: AttentionConfig):
    B, S, _ = x.shape
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p.w_q).reshape(B, S, H, dh).transpose(1, 2)
    k = (x @ p.w_k).reshape(B, S, Hkv, dh).transpose(1, 2)
    v = (x @ p.w_v).reshape(B, S, Hkv, dh).transpose(1, 2)
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


def gqa_train(p: Attention, x: Tensor, cfg: AttentionConfig,
              use_kernels: bool = False) -> Tensor:
    B, S, _ = x.shape
    if not use_kernels and S > CHUNKED_ATTN_THRESHOLD and S % QUERY_BLOCK == 0:
        raise NotImplementedError("not yet ported: query-chunked attention")
    q, k, v = _project_qkv(p, x, cfg)
    positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = _attn_flash(q, k, v, cfg) if use_kernels else _attn_dense(q, k, v, cfg, 0, S)
    o = o.transpose(1, 2).reshape(B, S, -1)
    return o @ p.w_o
