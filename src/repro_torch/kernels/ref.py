"""Plain PyTorch oracles for the kernels (port of ``repro/kernels/ref.py``).

The matmul and Adam-scale oracles are the plain versions that live beside
their kernels; the two-sided rotation oracle is written independently of
the matmul module, as einsums, the way the reference writes it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.adam_step import adam_scale_plain as fused_adam_scale_ref
from repro_torch.kernels.matmul import matmul_plain as matmul_ref

Tensor = torch.Tensor

__all__ = ["matmul_ref", "fused_adam_scale_ref", "two_sided_rotate_ref"]


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
