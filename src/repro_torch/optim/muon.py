"""Muon (Jordan et al., 2024): momentum plus Newton-Schulz orthogonalisation
of matrix updates. Port of ``repro/optim/muon.py``. Included for the
paper's Table 3 comparison against preconditioned optimizers: Muon does not
align with the Hessian eigenbasis. Leaves the rotation layout does not
rotate (embeddings, the head, norms, vectors) take Adam; on the rotated
leaves the second moment ``v`` stays zero, as in the reference.

The iteration works on the last two axes, so a stage-stacked ``(K, per, m,
n)`` leaf is orthogonalised as K * per matrices in one batched product.
Its products are plain ``torch.matmul`` in float32 (the launcher turns
TF32 off on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.layout import build_layout
from repro_torch.optim.adam import _zeros
from repro_torch.optim.base import Optimizer, Schedule, bias_correction

f32 = np.float32


def newton_schulz_orthogonalize(G: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Approximate U V^T of the SVD of G (over its last two axes) by the
    Newton-Schulz iteration.

    The first five iterations use Jordan's tuned quintic coefficients, which
    leave the singular values in a band around 1 (roughly [0.7, 1.2]). Any
    further steps use the cubic f(x) = 1.5x - 0.5x^3, which contracts the
    band to 1. steps <= 5 is Muon's own behaviour."""
    a, b, c = 3.4445, -4.7750, 2.0315
    X = G.float()
    transpose = X.shape[-2] > X.shape[-1]
    if transpose:
        X = X.mT
    X = X / (torch.linalg.matrix_norm(X, keepdim=True) + 1e-7)  # Frobenius
    for i in range(steps):
        A = X @ X.mT
        if i < 5:
            B = b * A + c * (A @ A)
            X = a * X + B @ X
        else:
            X = 1.5 * X - 0.5 * (A @ X)
    return X.mT if transpose else X


def muon(
    schedule: Schedule,
    momentum: float = 0.95,
    beta2: float = 0.999,
    eps: float = 1e-8,
    ns_steps: int = 5,
    min_dim: int = 8,
) -> Optimizer:
    def init(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def update(grads, state, params, step, aux=None):
        lr = schedule(step)
        layout = build_layout(params, "bilateral", min_dim)
        bc1, bc2 = bias_correction(momentum, step), bias_correction(beta2, step)
        new_m, new_v, updates = {}, {}, {}
        for (k, g), plan in zip(grads.items(), layout):
            g = g.float()
            m = momentum * state["m"][k] + (1 - momentum) * g
            v = state["v"][k]
            if plan.rotate:  # matrix parameter: orthogonalised momentum
                o = newton_schulz_orthogonalize(m, ns_steps)
                # Muon's RMS-matching factor sqrt(max(m, n)) * 0.2, in float32
                scale = f32(np.sqrt(f32(max(g.shape[-2], g.shape[-1])))) * f32(0.2)
                updates[k] = float(f32(-lr) * scale) * o
            else:
                v = beta2 * v + (1 - beta2) * torch.square(g)
                updates[k] = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            new_m[k], new_v[k] = m, v
        return updates, {"m": new_m, "v": new_v}

    return Optimizer(init, update)
