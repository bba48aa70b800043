"""Theory utilities: basis-misalignment proxies and effective delay. Port of
``repro/core/theory.py``.

The paper uses the Hessian (1,1)-norm ||H||_{1,1} = sum_ij |H_ij| as the
misalignment proxy (Section 2.3): for a fixed spectrum it is least when H is
diagonal (basis-aligned) and grows under rotation away from the eigenbasis.
Theorem E.6's stage-aware effective delay

    tau' = sqrt( sum_i C_i^2 tau_i^2 / sum_i C_i^2 )

is what the stage-aware frequency allocation minimises.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def norm_11(H: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(H))


def rotated_hessian(H: torch.Tensor, U: Optional[torch.Tensor],
                    V: Optional[torch.Tensor]) -> torch.Tensor:
    """Hessian of f(U w~ V^T) given H over vec(W): H~ = (V (x) U)^T H (V (x) U).

    For the Kronecker-structured case of Theorem 3.1, pass H = kron(A, B)
    with A (n x n), B (m x m) and rotations U (m x m), V (n x n)."""
    mn = H.shape[0]
    if U is None and V is None:
        return H
    eye = lambda k: torch.eye(k, dtype=H.dtype, device=H.device)  # noqa: E731
    if U is None:
        U = eye(mn // V.shape[0])
    if V is None:
        V = eye(mn // U.shape[0])
    T = torch.kron(V, U)
    return T.T @ H @ T


def effective_delay(c_sq: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """tau' = sqrt( sum C_i^2 tau_i^2 / sum C_i^2 )  (Eq. 3), in float32."""
    c_sq, taus = c_sq.float(), taus.float()
    return torch.sqrt(torch.sum(c_sq * taus ** 2) / torch.clamp(torch.sum(c_sq), min=1e-30))


def stage_effective_delay(stage_c_sq: Sequence[float], num_stages: int) -> float:
    """tau' from per-stage smoothness mass, tau_k = K-1-k for k = 0..K-1."""
    c = torch.as_tensor(stage_c_sq, dtype=torch.float32)
    taus = torch.tensor([num_stages - 1 - k for k in range(num_stages)], dtype=torch.float32)
    return float(effective_delay(c, taus))


def estimate_norm_11(hvp: Callable[[torch.Tensor], torch.Tensor], dim: int,
                     generator: torch.Generator, num_samples: int = 64) -> torch.Tensor:
    """Estimate ||H||_{1,1} by random Cauchy quadratic forms (Xie et al. 2025).

    For v with iid standard-Cauchy entries, v^T H v is approximately Cauchy
    with a scale of about ||H||_{1,1}; the median of |v^T H v| estimates the
    scale (the median of |Cauchy(0, s)| is s). The draws come from
    ``generator``, on its device; the median of an even count is the mean of
    the two middle samples, as ``jnp.median`` gives it."""
    v = torch.empty((num_samples, dim), device=generator.device).cauchy_(generator=generator)
    samples = torch.stack([torch.abs(torch.dot(x, hvp(x))) for x in v])
    return torch.quantile(samples, 0.5)


def model_hvp(loss_fn: Callable, params, flatten_fn: Callable,
              unflatten_fn: Callable) -> Callable:
    """Hessian-vector product over flattened parameters: forward-mode
    differentiation of ``loss_fn``'s gradient (``loss_fn`` takes the
    parameter tree, e.g. a dict of tensors)."""

    def hvp(v_flat: torch.Tensor) -> torch.Tensor:
        v = unflatten_fn(v_flat)
        _, tangent = torch.func.jvp(torch.func.grad(loss_fn), (params,), (v,))
        return flatten_fn(tangent)

    return hvp
