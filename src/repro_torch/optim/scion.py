"""Scion (Pethick et al., 2025): a conditional-gradient optimizer whose
update is the linear minimisation oracle (LMO) of the momentum over a
layer-appropriate norm ball, the last preconditioned baseline of the
paper's Table 3. Port of ``repro/optim/scion.py``.

  * rotated (hidden) matrices: the spectral-norm ball, the orthogonalised
    momentum (Newton-Schulz) scaled by sqrt(d_out / d_in);
  * embeddings, the head and vectors: the l1 -> linf ball, sign(momentum)
    times ``sign_scale``.

The state is the momentum ``{"m"}`` alone.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.layout import build_layout
from repro_torch.optim.adam import _new_state, _zeros
from repro_torch.optim.base import Optimizer, Schedule, ema
from repro_torch.optim.muon import newton_schulz_orthogonalize

f32 = np.float32


def scion(
    schedule: Schedule,
    momentum: float = 0.9,
    ns_steps: int = 5,
    min_dim: int = 8,
    sign_scale: float = 0.1,
) -> Optimizer:
    def init(params):
        return {"m": _zeros(params)}

    def update(grads, state, params, step, aux=None, inplace=False):
        lr = schedule(step)
        layout = build_layout(params, "bilateral", min_dim)
        new_m, updates = {}, {}
        for (k, g), plan in zip(grads.items(), layout):
            g = g.float()
            m = ema(state["m"][k], g, momentum, inplace)
            if plan.rotate:  # spectral-ball LMO
                o = newton_schulz_orthogonalize(m, ns_steps)
                scale = f32(np.sqrt(g.shape[-2] / max(g.shape[-1], 1)))
                updates[k] = float(f32(-lr) * scale) * o
            else:  # sign LMO (l1 -> linf)
                updates[k] = float(f32(-lr) * f32(sign_scale)) * torch.sign(m)
            new_m[k] = m
        return updates, _new_state(state, inplace, m=new_m)

    return Optimizer(init, update)
