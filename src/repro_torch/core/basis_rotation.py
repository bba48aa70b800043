"""Adam with Basis Rotation (paper Algorithm 1) — the core contribution.
Port of ``repro/core/basis_rotation.py``.

Per rotatable weight matrix W (m x n):
    G_t  <- grad                                  (original space)
    M_t  <- b1 M_{t-1} + (1-b1) G_t               (original space, Appendix G)
    if t % freq == 0:  U,V <- Eigenbasis-Estimation(G_t, M_t, U, V)
    G~ <- U^T G V ; M~ <- U^T M V                 (rotate at use time)
    V~_t <- b2 V~_{t-1} + (1-b2) G~^2             (rotated second moment)
    W <- W - lr * U ( M~ / sqrt(V~ + eps) ) V^T

Non-rotatable leaves (embeddings, norms, biases, 1-D params) take plain Adam.
State is a list of per-leaf dicts in the parameter dict's leaf order. The
rotated ``v`` lives in the eigenbasis and is never rotated back.

``freq`` is one int for every leaf, or one entry per leaf (stage-aware
allocation): an int for the whole leaf, or a tuple of K per-stage periods
over a stage-stacked ``(K, per, m, n)`` leaf's leading axis. A period <= 0
or >= ``stage_aware.NEVER`` never refreshes. The refresh is decided on the
host from the host step, and the Fisher EMAs L/R advance only on refresh
steps, as under the reference's ``lax.cond``. With tuple periods only the
stages due at this step are refreshed, batched over their layers, and the
other stages keep their U/V and L/R: the reference's per-stage masked
select, without computing the refresh it throws away.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch

from repro_torch.core.layout import LeafPlan, build_layout
from repro_torch.core.rotation import batched_eye, refresh_basis, rotate, unrotate
from repro_torch.core.stage_aware import NEVER
from repro_torch.optim.base import Optimizer, Schedule, bias_correction


def _init_leaf(p: torch.Tensor, plan: LeafPlan, source: str) -> Dict[str, torch.Tensor]:
    st = {
        "m": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        "v": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
    }
    if not plan.rotate:
        return st
    batch = tuple(p.shape[:-2])
    m, n = p.shape[-2], p.shape[-1]
    if plan.left:
        st["U"] = batched_eye(m, batch, p.device)
        if source == "2nd":
            st["L"] = torch.zeros(batch + (m, m), dtype=torch.float32, device=p.device)
    if plan.right:
        st["V"] = batched_eye(n, batch, p.device)
        if source == "2nd":
            st["R"] = torch.zeros(batch + (n, n), dtype=torch.float32, device=p.device)
    return st


FreqSpec = Union[int, Tuple[int, ...]]


def _due(f: int, step: int) -> bool:
    return 0 < f < NEVER and step % f == 0


def _refresh_ops(g, m, ops, freq: FreqSpec, step: int, source: str, beta2: float):
    """(U, V, L, R) after this step's refresh, if any (reference ``_refresh_ops``)."""
    if not isinstance(freq, tuple):
        return refresh_basis(g, m, *ops, source, beta2) if _due(freq, step) else ops
    if g.shape[0] != len(freq):
        raise ValueError(f"per-stage freqs {freq} need a leading stage axis of "
                         f"{len(freq)}, got leaf shape {tuple(g.shape)}")
    due = [k for k, f in enumerate(freq) if _due(f, step)]
    if not due:
        return ops
    if len(due) == len(freq):
        return refresh_basis(g, m, *ops, source, beta2)
    idx = torch.tensor(due, device=g.device)
    sub = [None if o is None else o[idx] for o in ops]
    new = refresh_basis(g[idx], m[idx], *sub, source, beta2)
    out = []
    for old, n in zip(ops, new):
        if old is not None:
            old = old.clone()
            old[idx] = n
        out.append(old)
    return tuple(out)


def _kernel_steps(kops, rotated, updates, lr, beta2, eps, bc1, bc2) -> None:
    """The rotated leaves' steps through the kernels, all leaves at once:
    one grouped launch each for U^T [G, M], [G, M] V, U S and S V^T, and one
    grouped fused Adam scale between them. Fills ``updates`` and each
    leaf's new ``v``. On the CPU every product is the same ``torch.matmul``
    and every Adam scale the same plain expression as a leaf-by-leaf
    rotation, so the two agree bitwise."""
    _, gs, ms, Us, Vs, vs, nsts = zip(*rotated)
    n = len(rotated)
    rot = kops.two_sided_rotate_grouped(gs + ms, Us + Us, Vs + Vs, transpose=True)
    steps, v_news = kops.adam_scale_grouped(rot[:n], rot[n:], vs, beta2, eps, bc1, bc2)
    for nst, v in zip(nsts, v_news):
        nst["v"] = v
    del rot  # the rotated gradients and momenta are dead before the back-rotation
    back = kops.two_sided_rotate_grouped(steps, Us, Vs, transpose=False)
    for (k, *_), u in zip(rotated, back):
        updates[k] = u.mul_(-lr)


def basis_rotation_adam(
    schedule: Schedule,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    source: str = "2nd",
    geometry: str = "bilateral",
    freq: Union[int, Sequence[FreqSpec]] = 10,
    weight_decay: float = 0.0,
    min_dim: int = 8,
    use_kernels: bool = False,
) -> Optimizer:
    if source not in ("1st", "2nd") or geometry not in ("unilateral", "bilateral"):
        raise ValueError(f"unknown source {source!r} or geometry {geometry!r}")
    if use_kernels:
        from repro_torch.kernels import ops as kops
    else:
        kops = None

    def init(params):
        layout = build_layout(params, geometry, min_dim)
        return {"leaves": [_init_leaf(p, pl, source)
                           for p, pl in zip(params.values(), layout)]}

    def update(grads, state, params, step: int, aux=None):
        layout = build_layout(params, geometry, min_dim)
        if isinstance(freq, int):
            freqs: List[FreqSpec] = [freq] * len(layout)
        else:
            freqs = [tuple(int(x) for x in f) if isinstance(f, (tuple, list)) else int(f)
                     for f in freq]
            if len(freqs) != len(layout):
                raise ValueError("freq list must match leaf count")
        lr = schedule(step)
        bc1, bc2 = bias_correction(beta1, step), bias_correction(beta2, step)

        new_leaves, updates, rotated = [], {}, []
        for (k, g), st, plan, f in zip(grads.items(), state["leaves"], layout, freqs):
            g = g.float()
            m = beta1 * st["m"] + (1 - beta1) * g
            nst = dict(st)
            nst["m"] = m
            if plan.rotate:
                U, V, L, R = _refresh_ops(
                    g, m, (st.get("U"), st.get("V"), st.get("L"), st.get("R")),
                    f, step, source, beta2)
                for name, val in (("U", U), ("V", V), ("L", L), ("R", R)):
                    if val is not None:
                        nst[name] = val
                if kops is not None:
                    # rotated below with every other rotated leaf; the
                    # placeholder keeps the updates in leaf order
                    rotated.append((k, g, m, U, V, st["v"], nst))
                    updates[k] = None
                else:
                    g_rot = rotate(g, U, V)
                    m_rot = rotate(m, U, V)
                    v = beta2 * st["v"] + (1 - beta2) * torch.square(g_rot)
                    step_rot = (m_rot / bc1) / (torch.sqrt(v / bc2) + eps)
                    nst["v"] = v
                    updates[k] = -lr * unrotate(step_rot, U, V)
            else:
                v = beta2 * st["v"] + (1 - beta2) * torch.square(g)
                updates[k] = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
                nst["v"] = v
            new_leaves.append(nst)
        if rotated:
            _kernel_steps(kops, rotated, updates, lr, beta2, eps, bc1, bc2)

        if weight_decay:
            # decoupled weight decay on matrices only (norms/biases exempt)
            for k, p in params.items():
                if p.ndim >= 2:
                    updates[k] = updates[k] - lr * weight_decay * p.detach().float()
        return updates, {"leaves": new_leaves}

    return Optimizer(init, update)
