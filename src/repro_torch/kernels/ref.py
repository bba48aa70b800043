"""Plain PyTorch oracles for the kernels (port of ``repro/kernels/ref.py``).

The matmul and Adam-scale oracles are the plain versions that live beside
their kernels; the two-sided rotation and attention oracles are written
independently of the kernel modules, as einsums and a softmax, the way the
reference writes them. Like the reference's, they take float32 or bfloat16
inputs, compute in float32 and return float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.adam_step import adam_scale_plain as fused_adam_scale_ref
from repro_torch.kernels.matmul import matmul_plain as matmul_ref

Tensor = torch.Tensor

__all__ = ["matmul_ref", "fused_adam_scale_ref", "two_sided_rotate_ref",
           "flash_attention_ref"]


def two_sided_rotate_ref(x: Tensor, U: Optional[Tensor], V: Optional[Tensor],
                         transpose: bool = True) -> Tensor:
    """transpose=True: U^T x V (into rotated space);
    transpose=False: U x V^T (back to original space). U/V may be None."""
    x = x.float()
    if U is not None:
        eq = "...ji,...jk->...ik" if transpose else "...ij,...jk->...ik"
        x = torch.einsum(eq, U.float(), x)
    if V is not None:
        eq = "...ij,...jk->...ik" if transpose else "...ik,...jk->...ij"
        x = torch.einsum(eq, x, V.float())
    return x


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None) -> Tensor:
    """O = softmax(Q K^T * scale + mask) V in float32. q, k, v: (B, H, S, dh),
    float32 or bfloat16."""
    S, dh = q.shape[-2], q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    s = s.masked_fill(~mask, -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v.float())
