"""Batched float32 matmul: the basis-rotation hot spot.

Port of ``repro/kernels/matmul.py::matmul`` (Pallas ``_matmul_kernel``). The
CUDA kernel is ``csrc/matmul.cu``; its header says what bounds it and how it
is built. ``matmul`` dispatches on the operands' device: CPU tensors take
``matmul_plain``, CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check, load_library

Tensor = torch.Tensor


def _op(x: Tensor, trans: bool) -> Tensor:
    return x.mT if trans else x


def matmul_plain(a: Tensor, b: Tensor, *, trans_a: bool = False,
                 trans_b: bool = False) -> Tensor:
    """op(a) @ op(b) in float32: the kernel's plain PyTorch version."""
    return torch.matmul(_op(a.float(), trans_a), _op(b.float(), trans_b))


def matmul(a: Tensor, b: Tensor, *, trans_a: bool = False,
           trans_b: bool = False) -> Tensor:
    """C = op(A) @ op(B), op = transpose of the last two dims where asked.

    a, b: float32, both 2-D or both 3-D with equal leading batch, contiguous.
    Transposed operands are read in place by the kernel.
    """
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b, trans_a=trans_a, trans_b=trans_b)
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"matmul: operands on {a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"matmul: float32 only, got {a.dtype} and {b.dtype}")
    if a.ndim != b.ndim or a.ndim not in (2, 3):
        raise ValueError(f"matmul: need two 2-D or two 3-D operands, got {a.shape}, {b.shape}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul: operands must be contiguous")
    a3 = a if a.ndim == 3 else a[None]
    b3 = b if b.ndim == 3 else b[None]
    batch = a3.shape[0]
    M, K = (a3.shape[2], a3.shape[1]) if trans_a else (a3.shape[1], a3.shape[2])
    K2, N = (b3.shape[2], b3.shape[1]) if trans_b else (b3.shape[1], b3.shape[2])
    if K != K2 or b3.shape[0] != batch:
        raise ValueError(f"matmul: shape mismatch {tuple(a.shape)} x {tuple(b.shape)} "
                         f"(trans_a={trans_a}, trans_b={trans_b})")
    if min(batch, M, N, K) < 1 or batch > 65535:
        raise ValueError(f"matmul: unsupported sizes batch={batch} M={M} N={N} K={K}")
    out = torch.empty((batch, M, N), dtype=torch.float32, device=a.device)
    lib = load_library().lib
    stream = torch.cuda.current_stream(a.device).cuda_stream
    check(lib.rbr_matmul_f32(a3.data_ptr(), b3.data_ptr(), out.data_ptr(), batch,
                             M, N, K, int(trans_a), int(trans_b), a.device.index,
                             stream), "matmul")
    matmul.launches += 1
    return out if a.ndim == 3 else out[0]


matmul.launches = 0
