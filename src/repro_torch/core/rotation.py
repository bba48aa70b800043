"""Eigenbasis estimation and rotation primitives (paper Algorithm 2).
Port of ``repro/core/rotation.py``.

All math is float32 and broadcasts over leading (stacked-layer) dimensions.
One power-iteration step + QR per refresh, with the sign convention
diag(R) >= 0 so that bases are reproducible.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def power_qr(A: Tensor, Q: Tensor) -> Tensor:
    """One power-iteration step followed by QR: Q' = qr(A @ Q).Q.

    A: (..., n, n) symmetric PSD; Q: (..., n, k) orthonormal columns.
    """
    Z = torch.matmul(A.float(), Q.float())
    Qn, R = torch.linalg.qr(Z)
    # QR is unique only up to column signs: make diag(R) >= 0
    sign = torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    # LAPACK hands Q back column-major; the bases are kernel operands for
    # every step until the next refresh, and the kernels take row-major
    return (Qn * sign[..., None, :]).contiguous()


def batched_eye(
    n: int, batch_shape: Tuple[int, ...], device: torch.device | str
) -> Tensor:
    eye = torch.eye(n, dtype=torch.float32, device=device)
    return eye.expand(batch_shape + (n, n)).clone()


def gram_left(g: Tensor) -> Tensor:
    """(..., m, n) -> (..., m, m) = G @ G^T."""
    g = g.float()
    return torch.matmul(g, g.mT)


def gram_right(g: Tensor) -> Tensor:
    """(..., m, n) -> (..., n, n) = G^T @ G."""
    g = g.float()
    return torch.matmul(g.mT, g)


def rotate(x: Tensor, U: Optional[Tensor], V: Optional[Tensor]) -> Tensor:
    """x_tilde = U^T x V (missing side = identity)."""
    x = x.float()
    if U is not None:
        x = torch.matmul(U.mT, x)
    if V is not None:
        x = torch.matmul(x, V)
    return x


def unrotate(x: Tensor, U: Optional[Tensor], V: Optional[Tensor]) -> Tensor:
    """x = U x_tilde V^T (missing side = identity)."""
    x = x.float()
    if U is not None:
        x = torch.matmul(U, x)
    if V is not None:
        x = torch.matmul(x, V.mT)
    return x


def refresh_basis(
    g: Tensor,
    m: Tensor,
    U: Optional[Tensor],
    V: Optional[Tensor],
    L: Optional[Tensor],
    R: Optional[Tensor],
    source: str,
    beta2: float,
):
    """One Eigenbasis-Estimation step (Algorithm 2). Returns (U, V, L, R)."""
    if source == "2nd":
        if U is not None:
            L = beta2 * L + (1 - beta2) * gram_left(g)
            U = power_qr(L, U)
        if V is not None:
            R = beta2 * R + (1 - beta2) * gram_right(g)
            V = power_qr(R, V)
    else:  # 1st: reuse the momentum buffer, no dedicated Fisher state
        if U is not None:
            U = power_qr(gram_left(m), U)
        if V is not None:
            V = power_qr(gram_right(m), V)
    return U, V, L, R
