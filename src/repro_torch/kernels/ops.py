"""Public wrappers over the kernels. Port of ``repro/kernels/ops.py``
(``two_sided_rotate``, ``adam_scale``, ``attention``).

Leading batch dims fold into the kernels' own batch axis instead of a vmap,
and operands are made contiguous here (a no-op for the contiguous tensors of
the training path), since the kernels take nothing else. Like the kernels
they call, these take the plain PyTorch versions for CPU tensors and launch
the CUDA kernels for CUDA tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import adam_step
from repro_torch.kernels.flash import flash_attention
from repro_torch.kernels.matmul import matmul

Tensor = torch.Tensor


def _batched(x: Tensor) -> Tensor:
    return x.float().contiguous().reshape((-1,) + tuple(x.shape[-2:]))


def two_sided_rotate(x: Tensor, U: Optional[Tensor] = None, V: Optional[Tensor] = None,
                     *, transpose: bool = True) -> Tensor:
    """U^T x V (transpose=True) or U x V^T (transpose=False), two kernel
    launches for a bilateral rotation. x: (..., m, n); U: (..., m, m);
    V: (..., n, n); U or V may be None for a unilateral rotation."""
    shape = x.shape
    y = _batched(x)
    if U is not None:
        y = matmul(_batched(U), y, trans_a=transpose)
    if V is not None:
        y = matmul(y, _batched(V), trans_b=not transpose)
    return y.reshape(shape)


def adam_scale(g: Tensor, m: Tensor, v: Tensor, beta2: float, eps: float,
               bc1: float, bc2: float) -> Tuple[Tensor, Tensor]:
    """Fused (step_dir, v_new) over tensors of any shape."""
    g, m, v = (x.float().contiguous() for x in (g, m, v))
    return adam_step.adam_scale(g, m, v, beta2, eps, bc1, bc2)


def attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
              window: Optional[int] = None) -> Tensor:
    """Flash attention over (B, H, S, dh): B1 forward, B2 and B3 backward.
    The reference's block sizes have no counterpart: the CUDA kernels use
    one 64 x 64 tile geometry at every shape."""
    return flash_attention(q, k, v, causal=causal, window=window)
