"""xLSTM mixers: mLSTM (matrix memory, parallelisable) and sLSTM (scalar
memory with a true recurrence), arXiv:2405.04517. Port of
``repro/models/xlstm.py``.

mLSTM training uses the stabilised parallel (quadratic) form, with queries
in blocks of ``MLSTM_QUERY_BLOCK`` (each recomputed in the backward) above
``MLSTM_CHUNK_THRESHOLD``; decoding uses the O(1) recurrent form with a
per-head matrix memory C of (dh x dh). sLSTM has a genuine sequential
recurrence (block-diagonal recurrent weights), so training loops over time;
its input product ``x @ w_x`` does not depend on the state, so it runs once
for the whole sequence before the loop, which computes the same function.

Both carry a log-space stabiliser m to keep the exponential gating bounded.
The row stabiliser of the parallel form is ``torch.amax``, which splits the
gradient over ties as ``jnp.max`` does. The functions take the mixer's
weights as a ``{name: tensor}`` dict (the reference's parameter dict), so
that the decode path runs them on compute-dtype copies of the masters.
Decode caches keep the sLSTM's ``h`` in the compute dtype and every other
state in float32, as the reference's do.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import dense_init, param

Tensor = torch.Tensor

NEG_INF = -1e30
MLSTM_QUERY_BLOCK = 1024
MLSTM_CHUNK_THRESHOLD = 8192


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_dims(d_model: int, cfg: SSMConfig) -> Tuple[int, int]:
    d_inner = int(cfg.proj_factor * d_model)
    return d_inner, d_inner // cfg.num_heads


class MLSTM(nn.Module):
    def __init__(self, d_model: int, cfg: SSMConfig, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d_inner, _ = _mlstm_dims(d_model, cfg)
        H = cfg.num_heads
        self.cfg = cfg
        self.up_proj = param(dense_init((d_model, 2 * d_inner), generator), dtype, device)
        self.w_q = param(dense_init((d_inner, d_inner), generator), dtype, device)
        self.w_k = param(dense_init((d_inner, d_inner), generator), dtype, device)
        self.w_v = param(dense_init((d_inner, d_inner), generator), dtype, device)
        self.w_i = param(dense_init((d_inner, H), generator), dtype, device)
        self.b_i = param(torch.zeros(H), torch.float32, device)
        self.w_f = param(dense_init((d_inner, H), generator), dtype, device)
        # positive forget-gate bias => long memory at init
        self.b_f = param(torch.linspace(3.0, 6.0, H), torch.float32, device)
        self.skip_scale = param(torch.ones(d_inner), dtype, device)
        self.down_proj = param(dense_init((d_inner, d_model), generator), dtype, device)

    def forward(self, x: Tensor) -> Tensor:
        return mlstm_train(dict(self.named_parameters()), x, self.cfg)


def _mlstm_qkv_gates(w: Mapping[str, Tensor], x: Tensor, cfg: SSMConfig):
    """x: (B, S, d_inner) -> q, k, v (B, H, S, dh), log_i and log_f (B, H, S)."""
    B, S, d_inner = x.shape
    H = cfg.num_heads
    dh = d_inner // H

    def heads(y):
        return y.reshape(B, S, H, dh).transpose(1, 2)

    q = heads(x @ w["w_q"])
    k = heads(x @ w["w_k"]) / math.sqrt(dh)
    v = heads(x @ w["w_v"])
    log_i = (x @ w["w_i"] + w["b_i"]).float().transpose(1, 2)
    log_f = F.logsigmoid((x @ w["w_f"] + w["b_f"]).float()).transpose(1, 2)
    return q, k, v, log_i, log_f


def _mlstm_parallel_block(q: Tensor, k: Tensor, v: Tensor, log_i: Tensor, Fc: Tensor,
                          offset: int, S: int) -> Tensor:
    """One query block of the stabilised parallel mLSTM form.

    q: (B, H, Sq, dh); k, v: (B, H, S, dh); log_i, Fc: (B, H, S); offset:
    the block's first query. D[i, j] = Fc_i - Fc_j + log_i_j for j <= i."""
    Sq = q.shape[2]
    Fq = Fc[..., offset: offset + Sq]
    D = Fq[..., :, None] - Fc[..., None, :] + log_i[..., None, :]
    i = offset + torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    D = D.masked_fill(j > i, NEG_INF)
    m = torch.amax(D, dim=-1)  # (B, H, Sq) row stabiliser
    Dstab = torch.exp(D - m[..., None])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    Sw = scores * Dstab
    n = torch.maximum(torch.abs(torch.sum(Sw, dim=-1)), torch.exp(-m))
    return torch.einsum("bhqk,bhkd->bhqd", Sw / n[..., None], v.float())


def mlstm_train(w: Mapping[str, Tensor], u: Tensor, cfg: SSMConfig) -> Tensor:
    B, S, _ = u.shape
    x, z = torch.chunk(u @ w["up_proj"], 2, dim=-1)
    q, k, v, log_i, log_f = _mlstm_qkv_gates(w, x, cfg)
    Fc = torch.cumsum(log_f, dim=-1)  # (B, H, S): sum_{t <= i} log f_t

    if S <= MLSTM_CHUNK_THRESHOLD or S % MLSTM_QUERY_BLOCK != 0:
        h = _mlstm_parallel_block(q, k, v, log_i, Fc, 0, S)
    else:
        h = torch.cat([checkpoint(_mlstm_parallel_block,
                                  q[:, :, o: o + MLSTM_QUERY_BLOCK], k, v, log_i, Fc, o, S,
                                  use_reentrant=False)
                       for o in range(0, S, MLSTM_QUERY_BLOCK)], dim=2)

    h = h.transpose(1, 2).reshape(B, S, -1).to(u.dtype)
    h = h + w["skip_scale"] * x  # learnable skip, keeps signal at init
    y = h * F.silu(z)
    return y @ w["down_proj"]


def init_mlstm_cache(batch: int, d_model: int, cfg: SSMConfig,
                     device) -> Dict[str, Tensor]:
    _, dh = _mlstm_dims(d_model, cfg)
    H = cfg.num_heads
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((batch, H, dh), dtype=f32, device=device),
        "m": torch.full((batch, H), NEG_INF, dtype=f32, device=device),
    }


def mlstm_decode(w: Mapping[str, Tensor], u: Tensor, cache: Dict[str, Tensor],
                 cfg: SSMConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One token u: (B, 1, d_model). Returns (y, the new cache)."""
    B = u.shape[0]
    x, z = torch.chunk(u @ w["up_proj"], 2, dim=-1)  # (B, 1, d_inner)
    q, k, v, log_i, log_f = _mlstm_qkv_gates(w, x, cfg)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]  # (B, H, dh)
    log_i, log_f = log_i[..., 0], log_f[..., 0]  # (B, H)

    m_new = torch.maximum(log_f + cache["m"], log_i)
    f_s = torch.exp(log_f + cache["m"] - m_new)[..., None]
    i_s = torch.exp(log_i - m_new)[..., None]
    kf, vf = k.float(), v.float()
    C = f_s[..., None] * cache["C"] + i_s[..., None] * kf[..., :, None] * vf[..., None, :]
    n = f_s * cache["n"] + i_s * kf
    qf = q.float()
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qf, n)), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, -1).to(u.dtype)
    h = h + w["skip_scale"] * x
    y = h * F.silu(z)
    return y @ w["down_proj"], {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    def __init__(self, d_model: int, cfg: SSMConfig, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        H = cfg.num_heads
        dh = d_model // H
        self.cfg = cfg
        # input weights for the 4 gates (i, f, z, o) stacked on the last axis
        self.w_x = param(dense_init((d_model, 4 * d_model), generator), dtype, device)
        # block-diagonal recurrent weights: per head (dh, 4 * dh)
        self.w_r = param(dense_init((H, dh, 4 * dh), generator, 1.0 / math.sqrt(dh)),
                         dtype, device)
        self.bias = param(torch.cat([torch.zeros(d_model), torch.linspace(3.0, 6.0, d_model),
                                     torch.zeros(2 * d_model)]), torch.float32, device)
        self.out_norm = param(torch.ones(d_model), dtype, device)
        d_ff = int(1.3 * d_model)
        self.ff_up = param(dense_init((d_model, d_ff), generator), dtype, device)
        self.ff_down = param(dense_init((d_ff, d_model), generator), dtype, device)

    def forward(self, x: Tensor) -> Tensor:
        return slstm_train(dict(self.named_parameters()), x, self.cfg)


def _slstm_cell(w: Mapping[str, Tensor], cfg: SSMConfig, xw_t: Tensor,
                state: Dict[str, Tensor]) -> Tuple[Dict[str, Tensor], Tensor]:
    """One sLSTM time step on its input's gate pre-activations
    xw_t = x_t @ w_x: (B, 4 d_model)."""
    B = xw_t.shape[0]
    d_model = xw_t.shape[1] // 4
    H = cfg.num_heads
    dh = d_model // H
    hH = state["h"].reshape(B, H, dh)
    rec = torch.einsum("bhd,hde->bhe", hH, w["w_r"]).reshape(B, 4 * d_model)
    pre = (xw_t + rec).float() + w["bias"]
    i_pre, f_pre, z_pre, o_pre = torch.chunk(pre, 4, dim=-1)

    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + state["m"], i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(log_f + state["m"] - m_new)
    c = f_s * state["c"] + i_s * torch.tanh(z_pre)
    n = torch.clamp_min(f_s * state["n"] + i_s, 1e-6)
    h = (torch.sigmoid(o_pre) * (c / n)).to(xw_t.dtype)
    return {"h": h, "c": c, "n": n, "m": m_new}, h


def init_slstm_cache(batch: int, d_model: int, cfg: SSMConfig, dtype,
                     device) -> Dict[str, Tensor]:
    f32 = torch.float32
    return {
        "h": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "c": torch.zeros((batch, d_model), dtype=f32, device=device),
        "n": torch.full((batch, d_model), 1e-6, dtype=f32, device=device),
        "m": torch.full((batch, d_model), NEG_INF, dtype=f32, device=device),
    }


def _slstm_out(w: Mapping[str, Tensor], h: Tensor) -> Tensor:
    h = h * w["out_norm"]
    return h + F.gelu(h @ w["ff_up"], approximate="tanh") @ w["ff_down"]


def slstm_train(w: Mapping[str, Tensor], u: Tensor, cfg: SSMConfig) -> Tensor:
    B, S, d_model = u.shape
    state = init_slstm_cache(B, d_model, cfg, u.dtype, u.device)
    xw = u @ w["w_x"]  # (B, S, 4 d_model): every step's input product at once
    hs = []
    for t in range(S):
        state, h = _slstm_cell(w, cfg, xw[:, t], state)
        hs.append(h)
    return _slstm_out(w, torch.stack(hs, dim=1))


def slstm_decode(w: Mapping[str, Tensor], u: Tensor, cache: Dict[str, Tensor],
                 cfg: SSMConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One token u: (B, 1, d_model). Returns (y, the new cache)."""
    new_state, h = _slstm_cell(w, cfg, u[:, 0] @ w["w_x"], cache)
    return _slstm_out(w, h)[:, None, :], new_state
