"""Float32 matrix products for the basis rotation, one problem or a group.

Port of ``repro/kernels/matmul.py::matmul`` (Pallas ``_matmul_kernel``). The
CUDA kernel is ``csrc/matmul.cu``; its header says what bounds it and how it
is built. One launch computes a whole group of products, each with its own
shapes and batch; ``matmul`` is a group of one. CPU tensors take the plain
versions (and meta tensors, which a dry run traces), CUDA tensors launch
the kernel or raise. ``matmul.launches``
counts launches of the kernel, one per group of up to ``MAX_PROBLEMS``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import check, load_library

Tensor = torch.Tensor

TILE_M = TILE_N = 128  # output tile of one block: csrc/matmul.cu's BM, BN
MAX_PROBLEMS = 512  # problems one launch's parameter table holds
# devices whose tensors take the plain version: the CPU, and the meta device
# of a dry run's trace (no data, so no kernel)
PLAIN_DEVICES = ("cpu", "meta")
_ALIGN = 4  # floats: every output starts 16-byte aligned, for the next product's loads

Dims = Tuple[int, int, int, int]  # (batch, M, N, K)


def _op(x: Tensor, trans: bool) -> Tensor:
    return x.mT if trans else x


def matmul_plain(a: Tensor, b: Tensor, *, trans_a: bool = False,
                 trans_b: bool = False) -> Tensor:
    """op(a) @ op(b) in float32: the kernel's plain PyTorch version."""
    return torch.matmul(_op(a.float(), trans_a), _op(b.float(), trans_b))


def matmul_grouped_plain(As: Sequence[Tensor], Bs: Sequence[Tensor], *,
                         trans_a: bool = False, trans_b: bool = False) -> List[Tensor]:
    """[op(a) @ op(b) for each pair]: the grouped kernel's plain version."""
    return [matmul_plain(a, b, trans_a=trans_a, trans_b=trans_b) for a, b in zip(As, Bs)]


def tile_table(dims: Sequence[Dims]) -> Tuple[List[int], List[int]]:
    """The launch's schedule: the problems in the order the kernel lists them
    (longest K first, ties in the given order) and the prefix sum of their
    output tiles over all batch entries, as ``csrc/matmul.cu`` reads it."""
    order = sorted(range(len(dims)), key=lambda i: -dims[i][3])
    start = [0]
    for i in order:
        batch, M, N, _ = dims[i]
        start.append(start[-1] + batch * -(-M // TILE_M) * -(-N // TILE_N))
    return order, start


def launch_tables(ptrs: Sequence[Tuple[int, int, int]], dims: Sequence[Dims], trans_a: bool,
                  trans_b: bool) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The kernel's parameter tables, one per launch of up to
    ``MAX_PROBLEMS`` problems, each in ``tile_table``'s order: the A, B, C
    addresses (int64, (P, 3)), M, N, K, batch and load flags (int32, (P, 5))
    and the tile prefix sum (int32, P + 1). Flag bit 1 (A) or 2 (B): the
    operand starts 16-byte aligned and its rows hold a multiple of 4 floats,
    so the kernel may load it by 16-byte copies."""
    ptrs = np.asarray(ptrs, dtype=np.int64).reshape(-1, 3)
    d = np.asarray(dims, dtype=np.int64).reshape(-1, 4)  # batch, M, N, K
    batch, M, N, K = d.T
    rows = np.stack([M if trans_a else K, K if trans_b else N], axis=1)
    vec = (ptrs[:, :2] % 16 == 0) & (rows % 4 == 0)
    meta = np.stack([M, N, K, batch, vec[:, 0] + 2 * vec[:, 1]], axis=1)
    tables = []
    for first in range(0, len(d), MAX_PROBLEMS):
        order, start = tile_table(dims[first:first + MAX_PROBLEMS])
        if start[-1] >= 2 ** 31:
            raise ValueError(f"matmul_grouped: {start[-1]} output tiles in one launch")
        idx = np.asarray(order) + first
        tables.append((np.ascontiguousarray(ptrs[idx]),
                       np.ascontiguousarray(meta[idx], dtype=np.int32),
                       np.asarray(start, dtype=np.int32)))
    return tables


def _dims(a: Tensor, b: Tensor, trans_a: bool, trans_b: bool, where: str) -> Dims:
    """(batch, M, N, K) of one problem; raises on what the kernel does not take."""
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"{where}: operands on {a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{where}: float32 only, got {a.dtype} and {b.dtype}")
    if a.ndim != b.ndim or a.ndim not in (2, 3):
        raise ValueError(f"{where}: need two 2-D or two 3-D operands, got {a.shape}, {b.shape}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{where}: operands must be contiguous")
    batch = a.shape[0] if a.ndim == 3 else 1
    M, K = (a.shape[-1], a.shape[-2]) if trans_a else (a.shape[-2], a.shape[-1])
    K2, N = (b.shape[-1], b.shape[-2]) if trans_b else (b.shape[-2], b.shape[-1])
    if K != K2 or (b.shape[0] if b.ndim == 3 else 1) != batch:
        raise ValueError(f"{where}: shape mismatch {tuple(a.shape)} x {tuple(b.shape)} "
                         f"(trans_a={trans_a}, trans_b={trans_b})")
    if min(batch, M, N, K) < 1 or max(M, N, K) > 2 ** 30:
        raise ValueError(f"{where}: unsupported sizes batch={batch} M={M} N={N} K={K}")
    return batch, M, N, K


def matmul_grouped(As: Sequence[Tensor], Bs: Sequence[Tensor], *, trans_a: bool = False,
                   trans_b: bool = False) -> List[Tensor]:
    """[op(A_i) @ op(B_i)] for a list of problems, op = transpose of the last
    two dims where asked (one pair of flags for the group).

    Each A_i, B_i: float32, contiguous, both 2-D or both 3-D with equal
    leading batch; shapes differ from problem to problem. Transposed
    operands are read in place. The outputs are views into one allocation.
    """
    if len(As) != len(Bs):
        raise ValueError(f"matmul_grouped: {len(As)} A operands, {len(Bs)} B operands")
    if not As:
        return []
    if all(x.device.type in PLAIN_DEVICES for x in (*As, *Bs)):
        return matmul_grouped_plain(As, Bs, trans_a=trans_a, trans_b=trans_b)
    dims = [_dims(a, b, trans_a, trans_b, "matmul_grouped") for a, b in zip(As, Bs)]
    device = As[0].device
    if any(a.device != device for a in As):
        raise ValueError("matmul_grouped: operands on more than one device")
    offsets, total = [], 0
    for batch, M, N, _ in dims:
        offsets.append(total)
        total += -(-batch * M * N // _ALIGN) * _ALIGN
    buf = torch.empty(total, dtype=torch.float32, device=device)
    outs = [buf[o:o + batch * M * N].view((batch, M, N) if a.ndim == 3 else (M, N))
            for o, (batch, M, N, _), a in zip(offsets, dims, As)]
    ptrs = [(a.data_ptr(), b.data_ptr(), o.data_ptr()) for a, b, o in zip(As, Bs, outs)]
    lib = load_library().lib
    stream = torch.cuda.current_stream(device).cuda_stream
    for p, meta, tiles in launch_tables(ptrs, dims, trans_a, trans_b):
        check(lib.rbr_matmul_grouped_f32(p.ctypes.data, meta.ctypes.data, tiles.ctypes.data,
                                         len(p), int(trans_a), int(trans_b), device.index,
                                         stream), "matmul_grouped")
        matmul.launches += 1
    return outs


def matmul(a: Tensor, b: Tensor, *, trans_a: bool = False,
           trans_b: bool = False) -> Tensor:
    """C = op(A) @ op(B): ``matmul_grouped`` over one problem.

    a, b: float32, both 2-D or both 3-D with equal leading batch, contiguous.
    """
    if a.device.type in PLAIN_DEVICES and b.device.type in PLAIN_DEVICES:
        return matmul_plain(a, b, trans_a=trans_a, trans_b=trans_b)
    return matmul_grouped([a], [b], trans_a=trans_a, trans_b=trans_b)[0]


matmul.launches = 0
