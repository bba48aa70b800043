"""Flash attention (online softmax), causal and sliding window, differentiable.

Port of ``repro/kernels/flash.py``. Three CUDA kernels, each beside its
plain PyTorch version and its launch counter:

* ``flash_fwd`` (B1, ``csrc/flash_fwd.cu``; replaces ``_flash_fwd_kernel``):
  O and the row logsumexp L = m + log l. A row that sees no key gives O = 0
  and L = ``NEG_INF``.
* ``flash_bwd_dq`` (B2, ``csrc/flash_bwd.cu``; replaces
  ``_flash_bwd_dq_kernel``): dQ = scale * dS K with p = exp(s*scale - L),
  dS = p * (dO V^T - D).
* ``flash_bwd_dkv`` (B3, ``csrc/flash_bwd.cu``; replaces
  ``_flash_bwd_dkv_kernel``): dV = p^T dO, dK = scale * dS^T Q.

Each wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors, or raises. The kernels' headers say what bounds
them on the card. ``FlashAttention`` joins them into one
``torch.autograd.Function`` that saves only q, k, v, O and L, the residuals
the 1F1B stash budget assumes; D = rowsum(dO * O) is an elementwise torch
reduction, as the reference computes it outside Pallas. Layout: (BH, S, dh)
at the kernels, (B, H, S, dh) at ``flash_attention``. The kernels mask the
ragged end of S themselves, so nothing is padded.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import check, load_library

Tensor = torch.Tensor

NEG_INF = -1e30
_EPS = 1e-30
HEAD_DIMS = (16, 32, 64)  # the head widths the kernels are built for


def _scale(dh: int) -> float:
    return float(np.float32(1.0 / math.sqrt(dh)))


def visible_mask(S: int, seq_len: int, causal: bool, window: Optional[int],
                 device) -> Tensor:
    """(S, S) bool: query row i sees key column j (the kernels' mask)."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    mask = j < seq_len
    if causal:
        mask = mask & (j <= i)
    if window is not None:
        mask = mask & (j > i - window)
    return mask


# ---------------------------------------------------------------------------
# plain versions, in the kernels' operation order
# ---------------------------------------------------------------------------


def flash_fwd_plain(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    seq_len: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """B1's plain version: (O, L) for (BH, S, dh) float32 inputs."""
    S, dh = q.shape[-2], q.shape[-1]
    mask = visible_mask(S, S if seq_len is None else seq_len, causal, window, q.device)
    s = torch.matmul(q, k.mT) * _scale(dh)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    o = torch.where(live, torch.matmul(p, v) / l.clamp(min=_EPS), torch.zeros_like(q))
    L = torch.where(live, m + torch.log(l.clamp(min=_EPS)), torch.full_like(l, NEG_INF))
    return o, L[..., 0]


def _p_ds(q, k, v, do, L, D, causal, window):
    S, dh = q.shape[-2], q.shape[-1]
    mask = visible_mask(S, S, causal, window, q.device)
    s = torch.matmul(q, k.mT) * _scale(dh)
    # fully-masked rows carry L = NEG_INF: the select keeps their overflowing
    # exp out of p
    p = torch.where(mask, torch.exp(s - L[..., None]), torch.zeros_like(s))
    ds = p * (torch.matmul(do, v.mT) - D[..., None])
    return p, ds


def flash_bwd_dq_plain(q: Tensor, k: Tensor, v: Tensor, do: Tensor, L: Tensor, D: Tensor, *,
                       causal: bool = True, window: Optional[int] = None) -> Tensor:
    """B2's plain version: dQ."""
    _, ds = _p_ds(q, k, v, do, L, D, causal, window)
    return torch.matmul(ds, k) * _scale(q.shape[-1])


def flash_bwd_dkv_plain(q: Tensor, k: Tensor, v: Tensor, do: Tensor, L: Tensor, D: Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """B3's plain version: (dK, dV)."""
    p, ds = _p_ds(q, k, v, do, L, D, causal, window)
    return torch.matmul(ds.mT, q) * _scale(q.shape[-1]), torch.matmul(p.mT, do)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*xs: Tensor) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def _check(what: str, heads: Tuple[Tensor, ...], rows: Tuple[Tensor, ...] = ()) -> None:
    """Raise on anything the kernels do not take."""
    x = heads[0]
    if not all(t.is_cuda and t.device == x.device for t in heads + rows):
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in heads + rows]}")
    if any(t.dtype != torch.float32 for t in heads + rows):
        raise TypeError(f"{what}: float32 only, got {[t.dtype for t in heads + rows]}")
    if x.ndim != 3 or any(t.shape != x.shape for t in heads):
        raise ValueError(f"{what}: need (BH, S, dh) tensors of one shape, "
                         f"got {[tuple(t.shape) for t in heads]}")
    BH, S, dh = x.shape
    if any(t.shape != (BH, S) for t in rows):
        raise ValueError(f"{what}: row statistics must be (BH, S), "
                         f"got {[tuple(t.shape) for t in rows]}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {dh} not in {HEAD_DIMS}")
    if not 1 <= BH <= 65535 or S < 1:
        raise ValueError(f"{what}: unsupported sizes BH={BH} S={S}")
    for t in heads + rows:
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be 16-byte aligned")


def _window(window: Optional[int]) -> int:
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0 or None, got {window}")
    return -1 if window is None else int(window)


def _stream(x: Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_fwd(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
              window: Optional[int] = None,
              seq_len: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """B1: (O (BH, S, dh), L (BH, S) float32). Keys at or past ``seq_len``
    (default S) are masked, as the reference masks its padding."""
    if _on_cpu(q, k, v):
        return flash_fwd_plain(q, k, v, causal=causal, window=window, seq_len=seq_len)
    _check("flash_fwd", (q, k, v))
    BH, S, dh = q.shape
    seq_len = S if seq_len is None else int(seq_len)
    if not 0 <= seq_len <= S:
        raise ValueError(f"flash_fwd: seq_len {seq_len} outside [0, {S}]")
    o = torch.empty_like(q)
    L = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    check(load_library().lib.rbr_flash_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), L.data_ptr(), BH, S, dh,
        seq_len, int(causal), _window(window), _scale(dh), q.device.index, _stream(q)),
        "flash_fwd")
    flash_fwd.launches += 1
    return o, L


def flash_bwd_dq(q: Tensor, k: Tensor, v: Tensor, do: Tensor, L: Tensor, D: Tensor, *,
                 causal: bool = True, window: Optional[int] = None) -> Tensor:
    """B2: dQ (BH, S, dh)."""
    if _on_cpu(q, k, v, do, L, D):
        return flash_bwd_dq_plain(q, k, v, do, L, D, causal=causal, window=window)
    _check("flash_bwd_dq", (q, k, v, do), (L, D))
    BH, S, dh = q.shape
    dq = torch.empty_like(q)
    check(load_library().lib.rbr_flash_bwd_dq_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), L.data_ptr(), D.data_ptr(),
        dq.data_ptr(), BH, S, dh, int(causal), _window(window), _scale(dh), q.device.index,
        _stream(q)), "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q: Tensor, k: Tensor, v: Tensor, do: Tensor, L: Tensor, D: Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """B3: (dK, dV), each (BH, S, dh)."""
    if _on_cpu(q, k, v, do, L, D):
        return flash_bwd_dkv_plain(q, k, v, do, L, D, causal=causal, window=window)
    _check("flash_bwd_dkv", (q, k, v, do), (L, D))
    BH, S, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    check(load_library().lib.rbr_flash_bwd_dkv_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), L.data_ptr(), D.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), BH, S, dh, int(causal), _window(window), _scale(dh),
        q.device.index, _stream(q)), "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def launched_blocks() -> dict:
    """Blocks in the grid of each kernel's last launch in this process, as the
    launch recorded them (0 before a kernel's first launch)."""
    grids = (ctypes.c_int * 3).in_dll(load_library().lib, "rbr_flash_blocks")
    return dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), grids))


class FlashAttention(torch.autograd.Function):
    """O = flash_fwd(q, k, v); the backward is B2 and B3. Saves q, k, v, O, L."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, causal: bool,
                window: Optional[int]) -> Tensor:
        o, L = flash_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, L)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do: Tensor):
        q, k, v, o, L = ctx.saved_tensors
        do = do.contiguous()
        D = (do * o).sum(dim=-1)
        kw = dict(causal=ctx.causal, window=ctx.window)
        dq = flash_bwd_dq(q, k, v, do, L, D, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, L, D, **kw)
        return dq, dk, dv, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None) -> Tensor:
    """q, k, v: (B, H, S, dh) float32 -> (B, H, S, dh); differentiable."""
    B, H, S, dh = q.shape
    flat = [x.reshape(B * H, S, dh).contiguous() for x in (q, k, v)]
    return FlashAttention.apply(*flat, causal, window).reshape(B, H, S, dh)
