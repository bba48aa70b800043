"""Flash attention (online softmax), causal and sliding window, differentiable.

Port of ``repro/kernels/flash.py``. Three CUDA kernels, each beside its
plain PyTorch version and its launch counter:

* ``flash_fwd`` (B1, ``csrc/flash_fwd_f32.cu``: 3xTF32 on ``wgmma`` at head
  widths 64 and 128, ``csrc/flash_fwd.cu`` on ``mma.sync`` at 16 and 32; on
  bf16 inputs ``csrc/flash_fwd_bf16.cu``; replaces ``_flash_fwd_kernel``): O
  and the row logsumexp L = m + log l. A row that sees no key gives O = 0
  and L = ``NEG_INF``.
* ``flash_bwd_dq`` (B2, ``csrc/flash_bwd_f32.cu``: 3xTF32 on ``wgmma`` at
  head width 128, ``csrc/flash_bwd.cu`` on ``mma.sync`` at 16, 32 and 64;
  on bf16 inputs ``csrc/flash_bwd_bf16.cu``; replaces
  ``_flash_bwd_dq_kernel``): dQ = scale * dS K with p = exp(s*scale - L),
  dS = p * (dO V^T - D).
* ``flash_bwd_dkv`` (B3, the same three files; replaces
  ``_flash_bwd_dkv_kernel``): dV = p^T dO, dK = scale * dS^T Q.

Each kernel has a float32 and a bfloat16 entry point (``_f32``, ``_bf16``),
as the reference's kernels take either: q, k, v and dO in one of the two
dtypes, L and D in float32, every sum in float32, and O, dQ, dK and dV
written in the input dtype. On bf16 inputs the backward rounds P and dS to
bf16 before their products, so that B2 and B3 multiply only bf16 operands;
the forward keeps P in float32 (its kernel splits P into two bf16 parts, so
the plain version rounds nothing).
Each wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors, or raises; it counts its launches by input dtype
(``launches`` for float32, ``launches_bf16``).
The kernels' headers say what bounds them on the card. ``FlashAttention``
joins them into one ``torch.autograd.Function`` that saves only q, k, v, O
and L, the residuals the 1F1B stash budget assumes; D = rowsum(dO * O),
computed in float32, is an elementwise torch reduction, as the reference
computes it outside Pallas. Layout: (BH, S, dh) at the kernels, (B, H, S,
dh) at ``flash_attention``. The kernels mask the ragged end of S
themselves, so nothing is padded along S. They are built for the head
widths in ``HEAD_DIMS``; ``flash_attention`` takes any width up to 128 by
zero-padding q, k and v to the next of them (``padded_width``), with the
softmax scale of the true width: the zero columns add nothing to the
scores, the output's padded columns are zeros, and slicing them off slices
the gradients back (the reference's ``BlockSpec``s cover any head width).
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
HEAD_DIMS = (16, 32, 64, 128)  # the head widths the kernels are built for
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}  # the kernels' input dtypes


def _scale(dh: int) -> float:
    return float(np.float32(1.0 / math.sqrt(dh)))


def padded_width(dh: int) -> int:
    """The head width the kernels run ``dh`` at: the least of ``HEAD_DIMS``
    that holds it. Widths above the largest are refused."""
    for width in HEAD_DIMS:
        if dh <= width:
            return width
    raise ValueError(f"flash_attention: head dim {dh} above {HEAD_DIMS[-1]}, the widest "
                     f"the kernels are built for")


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
# plain versions, in the kernels' operation order: bfloat16 inputs are
# upcast, everything is computed in float32 (or wider), the backward's P and
# dS are rounded to bf16 before their products, and the head-shaped outputs
# are cast back to the input dtype
# ---------------------------------------------------------------------------


def _up(*xs: Tensor):
    return [x.float() if x.dtype == torch.bfloat16 else x for x in xs]


def flash_fwd_plain(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None, seq_len: Optional[int] = None,
                    scale: Optional[float] = None) -> Tuple[Tensor, Tensor]:
    """B1's plain version: (O, L) for (BH, S, dh) inputs; O in their dtype.
    ``scale`` multiplies the scores (1/sqrt(dh) of the inputs' width by
    default), as in every wrapper and plain version here."""
    dt = q.dtype
    q, k, v = _up(q, k, v)
    S, dh = q.shape[-2], q.shape[-1]
    mask = visible_mask(S, S if seq_len is None else seq_len, causal, window, q.device)
    s = torch.matmul(q, k.mT) * (_scale(dh) if scale is None else scale)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    o = torch.where(live, torch.matmul(p, v) / l.clamp(min=_EPS), torch.zeros_like(q))
    L = torch.where(live, m + torch.log(l.clamp(min=_EPS)), torch.full_like(l, NEG_INF))
    return o.to(dt), L[..., 0]


def _p_ds(q, k, v, do, L, D, causal, window, scale):
    """P and dS of the backward, float32 (or wider). On bfloat16 inputs both
    are rounded to bf16 once, dS from the float32 P, as the kernels round
    them before their products (the bf16 x bf16 wgmma of B2 and B3)."""
    bf16 = q.dtype == torch.bfloat16
    q, k, v, do = _up(q, k, v, do)
    S, dh = q.shape[-2], q.shape[-1]
    mask = visible_mask(S, S, causal, window, q.device)
    s = torch.matmul(q, k.mT) * scale
    # fully-masked rows carry L = NEG_INF: the select keeps their overflowing
    # exp out of p
    p = torch.where(mask, torch.exp(s - L[..., None]), torch.zeros_like(s))
    ds = p * (torch.matmul(do, v.mT) - D[..., None])
    if bf16:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    return p, ds


def flash_bwd_dq_plain(q: Tensor, k: Tensor, v: Tensor, do: Tensor, L: Tensor, D: Tensor, *,
                       causal: bool = True, window: Optional[int] = None,
                       scale: Optional[float] = None) -> Tensor:
    """B2's plain version: dQ, in q's dtype."""
    scale = _scale(q.shape[-1]) if scale is None else scale
    _, ds = _p_ds(q, k, v, do, L, D, causal, window, scale)
    kf, = _up(k)
    return (torch.matmul(ds, kf) * scale).to(q.dtype)


def flash_bwd_dkv_plain(q: Tensor, k: Tensor, v: Tensor, do: Tensor, L: Tensor, D: Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> Tuple[Tensor, Tensor]:
    """B3's plain version: (dK, dV), in k's and v's dtypes."""
    scale = _scale(q.shape[-1]) if scale is None else scale
    p, ds = _p_ds(q, k, v, do, L, D, causal, window, scale)
    qf, dof = _up(q, do)
    return ((torch.matmul(ds.mT, qf) * scale).to(k.dtype),
            torch.matmul(p.mT, dof).to(v.dtype))


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*xs: Tensor) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def _check(what: str, heads: Tuple[Tensor, ...], rows: Tuple[Tensor, ...] = ()) -> str:
    """Raise on anything the kernels do not take; return the entry point's
    dtype suffix (``f32`` or ``bf16``)."""
    x = heads[0]
    if not all(t.is_cuda and t.device == x.device for t in heads + rows):
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in heads + rows]}")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in heads) or any(
            t.dtype != torch.float32 for t in rows):
        raise TypeError(f"{what}: heads all float32 or all bfloat16, row statistics "
                        f"float32; got {[t.dtype for t in heads]}, {[t.dtype for t in rows]}")
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
    return DTYPES[x.dtype]


def _window(window: Optional[int]) -> int:
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0 or None, got {window}")
    return -1 if window is None else int(window)


def _stream(x: Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_fwd(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
              window: Optional[int] = None, seq_len: Optional[int] = None,
              scale: Optional[float] = None) -> Tuple[Tensor, Tensor]:
    """B1: (O (BH, S, dh), L (BH, S) float32). Keys at or past ``seq_len``
    (default S) are masked, as the reference masks its padding. ``scale``
    multiplies the scores: 1/sqrt(dh) by default, that of the true width
    when the heads were zero-padded."""
    if _on_cpu(q, k, v):
        return flash_fwd_plain(q, k, v, causal=causal, window=window, seq_len=seq_len,
                               scale=scale)
    dt = _check("flash_fwd", (q, k, v))
    BH, S, dh = q.shape
    scale = _scale(dh) if scale is None else float(scale)
    seq_len = S if seq_len is None else int(seq_len)
    if not 0 <= seq_len <= S:
        raise ValueError(f"flash_fwd: seq_len {seq_len} outside [0, {S}]")
    o = torch.empty_like(q)
    L = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    check(getattr(load_library().lib, f"rbr_flash_fwd_{dt}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), L.data_ptr(), BH, S, dh,
        seq_len, int(causal), _window(window), scale, q.device.index, _stream(q)),
        "flash_fwd")
    _count(flash_fwd, dt)
    return o, L


def flash_bwd_dq(q: Tensor, k: Tensor, v: Tensor, do: Tensor, L: Tensor, D: Tensor, *,
                 causal: bool = True, window: Optional[int] = None,
                 scale: Optional[float] = None) -> Tensor:
    """B2: dQ (BH, S, dh)."""
    if _on_cpu(q, k, v, do, L, D):
        return flash_bwd_dq_plain(q, k, v, do, L, D, causal=causal, window=window, scale=scale)
    dt = _check("flash_bwd_dq", (q, k, v, do), (L, D))
    BH, S, dh = q.shape
    scale = _scale(dh) if scale is None else float(scale)
    dq = torch.empty_like(q)
    check(getattr(load_library().lib, f"rbr_flash_bwd_dq_{dt}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), L.data_ptr(), D.data_ptr(),
        dq.data_ptr(), BH, S, dh, int(causal), _window(window), scale, q.device.index,
        _stream(q)), "flash_bwd_dq")
    _count(flash_bwd_dq, dt)
    return dq


def flash_bwd_dkv(q: Tensor, k: Tensor, v: Tensor, do: Tensor, L: Tensor, D: Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> Tuple[Tensor, Tensor]:
    """B3: (dK, dV), each (BH, S, dh)."""
    if _on_cpu(q, k, v, do, L, D):
        return flash_bwd_dkv_plain(q, k, v, do, L, D, causal=causal, window=window,
                                   scale=scale)
    dt = _check("flash_bwd_dkv", (q, k, v, do), (L, D))
    BH, S, dh = q.shape
    scale = _scale(dh) if scale is None else float(scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    check(getattr(load_library().lib, f"rbr_flash_bwd_dkv_{dt}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), L.data_ptr(), D.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), BH, S, dh, int(causal), _window(window), scale,
        q.device.index, _stream(q)), "flash_bwd_dkv")
    _count(flash_bwd_dkv, dt)
    return dk, dv


def _count(wrapper, dt: str) -> None:
    """One more launch of ``wrapper``'s kernel for inputs of dtype ``dt``."""
    name = "launches" if dt == "f32" else "launches_bf16"
    setattr(wrapper, name, getattr(wrapper, name) + 1)


for _fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
    _fn.launches = 0  # float32 inputs
    _fn.launches_bf16 = 0  # bfloat16 inputs


def launched_blocks() -> dict:
    """Blocks in the grid of each kernel's last launch in this process, as the
    launch recorded them (0 before a kernel's first launch): the float32 B1
    at head dims 64 and 128 (``csrc/flash_fwd_f32.cu``) a cluster per 64
    rows of each head, of four blocks at 64 and two at 128, sharing the
    rows' key tiles, at 16 and 32 one per 16 rows; the float32 B2 and B3
    at head dim 128 (``csrc/flash_bwd_f32.cu``) a cluster of two blocks per
    64 rows, one computing S and the other dP (B2: each writing half of
    dQ's columns; B3: one writing dV, the other dK), at 16, 32 and 64
    (``csrc/flash_bwd.cu``) one per 16 rows; the bf16 B1, B2 and B3 (``csrc/flash_fwd_bf16.cu``,
    ``csrc/flash_bwd_bf16.cu``) one per 64 rows."""
    grids = (ctypes.c_int * 3).in_dll(load_library().lib, "rbr_flash_blocks")
    return dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), grids))


# The static analyzer's call counter (``analysis.trace``): None unless an
# audit records a step. Called as ``CALL_HOOK(ctx, "forward")`` before B1
# and ``CALL_HOOK(ctx, "backward")`` before B2 and B3, on the CPU (plain
# versions) as on the card.
CALL_HOOK = None


class FlashAttention(torch.autograd.Function):
    """O = flash_fwd(q, k, v); the backward is B2 and B3. Saves q, k, v, O, L."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, causal: bool,
                window: Optional[int], scale: Optional[float] = None) -> Tensor:
        if CALL_HOOK is not None:
            CALL_HOOK(ctx, "forward")
        o, L = flash_fwd(q, k, v, causal=causal, window=window, scale=scale)
        ctx.save_for_backward(q, k, v, o, L)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return o

    @staticmethod
    def backward(ctx, do: Tensor):
        if CALL_HOOK is not None:
            CALL_HOOK(ctx, "backward")
        q, k, v, o, L = ctx.saved_tensors
        do = do.contiguous()
        D = (do.float() * o.float()).sum(dim=-1)
        kw = dict(causal=ctx.causal, window=ctx.window, scale=ctx.scale)
        dq = flash_bwd_dq(q, k, v, do, L, D, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, L, D, **kw)
        return dq, dk, dv, None, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None) -> Tensor:
    """q, k, v: (B, H, S, dh) float32 or bfloat16 -> (B, H, S, dh) in their
    dtype; differentiable. A width outside ``HEAD_DIMS`` (up to 128) runs
    zero-padded to ``padded_width(dh)`` at the scale of ``dh``, and the
    padded columns of the output are sliced off."""
    B, H, S, dh = q.shape
    width = padded_width(dh)
    flat = [x.reshape(B * H, S, dh) for x in (q, k, v)]
    if width == dh:
        flat = [x.contiguous() for x in flat]
        return FlashAttention.apply(*flat, causal, window).reshape(B, H, S, dh)
    flat = [torch.nn.functional.pad(x, (0, width - dh)) for x in flat]
    o = FlashAttention.apply(*flat, causal, window, _scale(dh))
    return o[..., :dh].reshape(B, H, S, dh)
