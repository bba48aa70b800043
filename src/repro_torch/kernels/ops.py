"""Public wrappers over the kernels. Port of ``repro/kernels/ops.py``
(``two_sided_rotate``, ``adam_scale``, ``attention``), plus
``two_sided_rotate_grouped``, which rotates a list of leaves in two
grouped launches, and ``adam_scale_grouped``, which updates a list of
leaves in one.

Leading batch dims fold into the kernels' own batch axis instead of a vmap,
and operands are made contiguous here (a no-op for the contiguous tensors of
the training path), since the kernels take nothing else. Like the kernels
they call, these take the plain PyTorch versions for CPU tensors and launch
the CUDA kernels for CUDA tensors.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import adam_step
from repro_torch.kernels.flash import flash_attention
from repro_torch.kernels.matmul import matmul_grouped

Tensor = torch.Tensor


def _batched(x: Tensor) -> Tensor:
    return x.float().contiguous().reshape((-1,) + tuple(x.shape[-2:]))


def two_sided_rotate_grouped(xs: Sequence[Tensor], Us: Sequence[Optional[Tensor]],
                             Vs: Sequence[Optional[Tensor]], *,
                             transpose: bool = True) -> List[Tensor]:
    """[U_i^T x_i V_i] (transpose=True) or [U_i x_i V_i^T] (transpose=False)
    over a list of leaves, in two grouped launches: every left product in
    one, then every right product in the other. A leaf whose U (or V) is
    None skips that side; a launch with no product is not made. Each x_i:
    (..., m, n); U_i: (..., m, m); V_i: (..., n, n)."""
    ys = [_batched(x) for x in xs]
    left = [i for i, U in enumerate(Us) if U is not None]
    for i, y in zip(left, matmul_grouped([_batched(Us[i]) for i in left],
                                         [ys[i] for i in left], trans_a=transpose)):
        ys[i] = y
    right = [i for i, V in enumerate(Vs) if V is not None]
    for i, y in zip(right, matmul_grouped([ys[i] for i in right],
                                          [_batched(Vs[i]) for i in right],
                                          trans_b=not transpose)):
        ys[i] = y
    return [y.reshape(x.shape) for x, y in zip(xs, ys)]


def two_sided_rotate(x: Tensor, U: Optional[Tensor] = None, V: Optional[Tensor] = None,
                     *, transpose: bool = True) -> Tensor:
    """U^T x V (transpose=True) or U x V^T (transpose=False) for one leaf:
    ``two_sided_rotate_grouped`` over a group of one."""
    return two_sided_rotate_grouped([x], [U], [V], transpose=transpose)[0]


def adam_scale_grouped(gs: Sequence[Tensor], ms: Sequence[Tensor], vs: Sequence[Tensor],
                       beta2: float, eps: float, bc1: float, bc2: float,
                       inplace: bool = False) -> Tuple[List[Tensor], List[Tensor]]:
    """Fused ([step_dir_i], [v_new_i]) over a list of leaves of any shapes,
    in one launch; with ``inplace`` each v_new_i is written over v_i, which
    must then be contiguous float32 already."""
    if inplace and not all(v.dtype == torch.float32 and v.is_contiguous() for v in vs):
        raise ValueError("adam_scale_grouped: in place needs contiguous float32 v")
    gs, ms, vs = ([x.float().contiguous() for x in xs] for xs in (gs, ms, vs))
    return adam_step.adam_scale_grouped(gs, ms, vs, beta2, eps, bc1, bc2, inplace)


def adam_scale(g: Tensor, m: Tensor, v: Tensor, beta2: float, eps: float,
               bc1: float, bc2: float) -> Tuple[Tensor, Tensor]:
    """Fused (step_dir, v_new) over tensors of any shape."""
    g, m, v = (x.float().contiguous() for x in (g, m, v))
    return adam_step.adam_scale(g, m, v, beta2, eps, bc1, bc2)


def attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
              window: Optional[int] = None) -> Tensor:
    """Flash attention over (B, H, S, dh): B1 forward, B2 and B3 backward,
    at any head width up to 128 (zero-padded to a built one). The
    reference's block sizes, and its tuned plans, have no counterpart: each
    CUDA kernel is built for one geometry per head width and dtype, and
    reads no plan from ``repro_torch.tune`` (whose entries for it record
    that geometry's cost and time)."""
    return flash_attention(q, k, v, causal=causal, window=window)
