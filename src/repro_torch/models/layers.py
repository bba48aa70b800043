"""Basic layers: norms, rotary embeddings, MLPs, initialisers.
Port of ``repro/models/layers.py``.

Projection weights keep the reference's (in, out) orientation and are
applied as ``x @ W``, so every parameter converts one-to-one between the
packages and the basis-rotation sides (U on rows, V on columns) agree.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


def dense_init(shape: Tuple[int, ...], generator: Optional[torch.Generator],
               scale: Optional[float] = None) -> Tensor:
    """Truncated-normal fan-in initialiser, on the CPU."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32)
    if generator is not None:
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(std)
    return w


def embed_init(shape: Tuple[int, ...], generator: Optional[torch.Generator]) -> Tensor:
    w = torch.empty(shape, dtype=torch.float32)
    if generator is not None:
        w.normal_(0.0, 0.02, generator=generator)
    return w


def param(t: Tensor, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(t.to(device=device, dtype=dtype))


class Norm(nn.Module):
    """LayerNorm (scale and bias) or RMSNorm (scale only)."""

    def __init__(self, kind: str, dim: int, dtype: torch.dtype, device):
        super().__init__()
        self.scale = param(torch.ones(dim), dtype, device)
        if kind == "layernorm":
            self.bias = param(torch.zeros(dim), dtype, device)
        else:
            self.bias = None

    def forward(self, x: Tensor) -> Tensor:
        return apply_norm(self.scale, self.bias, x)


def apply_norm(scale: Tensor, bias: Optional[Tensor], x: Tensor, eps: float = 1e-6) -> Tensor:
    """Population-variance LayerNorm (``bias`` given) or RMSNorm, in float32."""
    orig_dtype = x.dtype
    x = x.float()
    if bias is not None:
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        y = (x - mean) * torch.rsqrt(var + eps)
        y = y * scale.float() + bias.float()
    else:
        ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
        y = x * torch.rsqrt(ms + eps) * scale.float()
    return y.to(orig_dtype)


def rms_norm_headwise(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """Per-head RMS norm over the trailing head_dim (qk_norm), in float32,
    cast back to x's dtype."""
    orig = x.dtype
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(orig)


def rope_frequencies(head_dim: int, theta: float, device) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Half-split rotary embedding. x: (..., seq, head_dim); positions: (seq,)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)
    angles = positions[..., None].float() * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class MLP(nn.Module):
    """GELU (tanh approximation, as ``jax.nn.gelu``) or SwiGLU MLP."""

    def __init__(self, d_model: int, d_ff: int, act: str, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        if act == "swiglu":
            self.w_gate = param(dense_init((d_model, d_ff), generator), dtype, device)
        self.w_up = param(dense_init((d_model, d_ff), generator), dtype, device)
        self.w_down = param(dense_init((d_ff, d_model), generator), dtype, device)

    def forward(self, x: Tensor) -> Tensor:
        return apply_mlp(dict(self.named_parameters()), x)


def apply_mlp(w: Mapping[str, Tensor], x: Tensor) -> Tensor:
    """The MLP on a ``{name: tensor}`` dict of its weights: SwiGLU when it
    holds ``w_gate``, else GELU."""
    if "w_gate" in w:
        h = F.silu(x @ w["w_gate"]) * (x @ w["w_up"])
    else:
        h = F.gelu(x @ w["w_up"], approximate="tanh")
    return h @ w["w_down"]
