"""Fused second-moment / step update of the rotated Adam, over a group of leaves.

Port of ``repro/kernels/adam_step.py::fused_adam_scale`` (Pallas
``_adam_kernel``). The CUDA kernel is ``csrc/adam_step.cu``; its header says
what bounds it and how it is built. One launch updates a whole group of
leaves of any shapes; ``adam_scale`` is a group of one. CPU tensors take
``adam_scale_plain`` (and meta tensors, which a dry run traces), CUDA
tensors launch the kernel or raise.
``adam_scale.launches`` counts launches of the kernel, one per group of up
to ``MAX_LEAVES`` leaves that holds any element, through either entry;
``adam_scale.chunks`` lists the chunk of each launch of the last call.

The chunk (elements one block takes) is the one launch parameter chosen
at run time. A CUDA launch over ``E`` elements in all first asks the
tuner's cache (``repro_torch.tune.kernel_plan("adam_scale", (E,),
"float32", platform)``); a miss keeps ``chunk_size``'s rule, and a cached
chunk the kernel does not take raises. Every chunk gives the same bits.

Computes, in float32:
    v'   = b2 * v + (1 - b2) * g^2
    step = (m / bc1) / (sqrt(v' / bc2) + eps)
and returns (step, v'). As in the reference kernel, the scalars are float32
and (1 - b2) is formed from float32 b2. ``adam_scale_grouped(...,
inplace=True)`` writes each v' over its v (the kernel's ``v_out`` is ``v``):
the optimizer's in-place update, which keeps no second copy of the second
moments; ``adam_scale_plain(..., out=v)`` is its plain version.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import check, load_library
from repro_torch.kernels.matmul import PLAIN_DEVICES

Tensor = torch.Tensor

THREADS = 256  # threads of one block: csrc/adam_step.cu's THREADS
MAX_LEAVES = 256  # leaves one launch's parameter table holds
CHUNK_MIN, CHUNK_MAX = 4 * THREADS, 32 * THREADS  # elements one block takes
FILL_BLOCKS = 1024  # blocks a launch should have before its chunks grow past CHUNK_MIN
CHUNKS = (1024, 2048, 4096, 8192)  # the chunks a launch takes: powers of two in between

# one launch's parameter table: the g, m, v, step, v' addresses (int64, (L, 5)), the
# element counts (int64, L), the 16-byte-load flags (int32, L), the chunk prefix sum
# (int32, L + 1) and the chunk size in elements
Table = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]


def _scalars(beta2, eps, bc1, bc2):
    b2 = np.float32(beta2)
    return (float(b2), float(np.float32(1) - b2), float(np.float32(eps)),
            float(np.float32(bc1)), float(np.float32(bc2)))


def adam_scale_plain(g: Tensor, m: Tensor, v: Tensor, beta2: float, eps: float,
                     bc1: float, bc2: float, out: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Tensor]:
    """The kernel's plain PyTorch version, in the kernel's operation order;
    v' goes into ``out`` when one is given (``v`` itself for the in-place
    update)."""
    b2, omb2, eps, bc1, bc2 = _scalars(beta2, eps, bc1, bc2)
    g, m, v = g.float(), m.float(), v.float()
    v_new = torch.add(b2 * v, omb2 * g * g, out=out)
    step = (m / bc1) / (torch.sqrt(v_new / bc2) + eps)
    return step, v_new


def chunk_size(elements: int) -> int:
    """Elements per block for a launch over ``elements`` in all: the largest
    power of two from ``CHUNK_MIN`` to ``CHUNK_MAX`` that still gives about
    ``FILL_BLOCKS`` blocks, so a whole step takes long chunks and a lone
    small leaf still spreads over the card."""
    chunk = CHUNK_MAX
    while chunk > CHUNK_MIN and elements < chunk * FILL_BLOCKS:
        chunk //= 2
    return chunk


def planned_chunk(elements: int, device: torch.device) -> int:
    """The chunk of a CUDA launch over ``elements``: the tuner's cached
    plan for it on this card, else ``chunk_size``'s rule. A cached chunk the
    kernel does not take raises, naming its key and the cache file."""
    from repro_torch import tune

    platform = tune.platform_name(device)
    plan = tune.kernel_plan("adam_scale", (elements,), "float32", platform)
    if plan is None:
        return chunk_size(elements)
    chunk = plan.get("chunk")
    if chunk not in CHUNKS:
        key = tune.make_key("adam_scale", (elements,), "float32", platform)
        raise ValueError(f"adam_scale: the cached plan {key!r} in {tune.cache_path()} holds "
                         f"chunk {chunk!r}; the kernel takes {CHUNKS}")
    return chunk


def launch_tables(ptrs: Sequence[Tuple[int, int, int, int, int]],
                  numels: Sequence[int],
                  chunk_of: Callable[[int], int] = chunk_size) -> List[Table]:
    """The kernel's parameter tables, one per launch of up to ``MAX_LEAVES``
    leaves in the given order. A leaf's flag is 1 when its five addresses
    are 16-byte aligned and its length is a multiple of 4, so the kernel
    may move it by 16-byte loads and stores. Leaf i holds chunks
    ``start[i] <= c < start[i + 1]``, each of ``chunk`` elements but its
    last; a leaf with no elements holds none. ``chunk_of`` gives a launch's
    chunk from its elements in all."""
    ptrs = np.asarray(ptrs, dtype=np.int64).reshape(-1, 5)
    n = np.asarray(numels, dtype=np.int64).reshape(-1)
    vec = ((ptrs % 16 == 0).all(axis=1) & (n % 4 == 0)).astype(np.int32)
    tables = []
    for first in range(0, len(n), MAX_LEAVES):
        part = slice(first, first + MAX_LEAVES)
        chunk = chunk_of(int(n[part].sum()))
        start = np.concatenate([[0], np.cumsum(-(-n[part] // chunk))])
        if start[-1] >= 2 ** 31:
            raise ValueError(f"adam_scale_grouped: {start[-1]} chunks in one launch")
        tables.append((np.ascontiguousarray(ptrs[part]), np.ascontiguousarray(n[part]),
                       np.ascontiguousarray(vec[part]), start.astype(np.int32), chunk))
    return tables


def _check(i: int, g: Tensor, m: Tensor, v: Tensor, device: torch.device) -> None:
    """Raise on a leaf the kernel does not take."""
    if not (g.device == m.device == v.device == device):
        raise ValueError(f"adam_scale_grouped: leaf {i} on {g.device}, {m.device}, {v.device}"
                         f" in a group on {device}")
    if not (g.dtype == m.dtype == v.dtype == torch.float32):
        raise TypeError(f"adam_scale_grouped: leaf {i}: float32 only, got {g.dtype}, "
                        f"{m.dtype}, {v.dtype}")
    if not (g.shape == m.shape == v.shape):
        raise ValueError(f"adam_scale_grouped: leaf {i}: shapes differ {tuple(g.shape)}, "
                         f"{tuple(m.shape)}, {tuple(v.shape)}")
    if not (g.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"adam_scale_grouped: leaf {i}: tensors must be contiguous")


def adam_scale_grouped(gs: Sequence[Tensor], ms: Sequence[Tensor], vs: Sequence[Tensor],
                       beta2: float, eps: float, bc1: float, bc2: float,
                       inplace: bool = False,
                       chunk: Optional[int] = None) -> Tuple[List[Tensor], List[Tensor]]:
    """([step_i], [v'_i]) for lists of float32 g_i, m_i, v_i (one shape per
    leaf, contiguous; shapes differ from leaf to leaf); scalars are host
    floats. Every step_i has storage of its own, allocated leaf by leaf as
    launches of one leaf each allocated them. Each v'_i outlives the step
    as optimizer state: in storage of its own too, or with ``inplace`` in
    v_i's (the returned v'_i are then the v_i themselves). ``chunk`` (one
    of ``CHUNKS``) fixes every launch's chunk, as the tuner times them;
    by default ``planned_chunk`` picks it."""
    if not (len(gs) == len(ms) == len(vs)):
        raise ValueError(f"adam_scale_grouped: {len(gs)} g, {len(ms)} m, {len(vs)} v")
    if not gs:
        return [], []
    if all(x.device.type in PLAIN_DEVICES for x in (*gs, *ms, *vs)):
        pairs = [adam_scale_plain(g, m, v, beta2, eps, bc1, bc2, out=v if inplace else None)
                 for g, m, v in zip(gs, ms, vs)]
        return [s for s, _ in pairs], [vn for _, vn in pairs]
    device = gs[0].device
    if not gs[0].is_cuda:
        raise ValueError(f"adam_scale_grouped: tensors on {device}, not on a CUDA device")
    if chunk is not None and chunk not in CHUNKS:
        raise ValueError(f"adam_scale_grouped: chunk {chunk} not in {CHUNKS}")
    for i, (g, m, v) in enumerate(zip(gs, ms, vs)):
        _check(i, g, m, v, device)
    # in place, each element of v is read and then written by one thread of
    # the kernel and by no other (csrc/adam_step.cu), so v' may go over v
    outs = [(torch.empty_like(g), v if inplace else torch.empty_like(g))
            for g, v in zip(gs, vs)]
    steps, v_news = [s for s, _ in outs], [vn for _, vn in outs]
    ptrs = [(g.data_ptr(), m.data_ptr(), v.data_ptr(), s.data_ptr(), vn.data_ptr())
            for g, m, v, (s, vn) in zip(gs, ms, vs, outs)]
    b2, _, eps, bc1, bc2 = _scalars(beta2, eps, bc1, bc2)
    lib = load_library().lib
    stream = torch.cuda.current_stream(device).cuda_stream
    chunk_of = ((lambda _: chunk) if chunk is not None
                else (lambda elements: planned_chunk(elements, device)))
    adam_scale.chunks = []
    for p, n, vec, start, c in launch_tables(ptrs, [g.numel() for g in gs], chunk_of):
        if start[-1] == 0:
            continue  # no leaf of this part holds an element
        check(lib.rbr_adam_scale_grouped_f32(p.ctypes.data, n.ctypes.data, vec.ctypes.data,
                                             start.ctypes.data, len(n), c, b2, eps, bc1,
                                             bc2, device.index, stream),
              "adam_scale_grouped")
        adam_scale.launches += 1
        adam_scale.chunks.append(c)
    return steps, v_news


def adam_scale(g: Tensor, m: Tensor, v: Tensor, beta2: float, eps: float,
               bc1: float, bc2: float) -> Tuple[Tensor, Tensor]:
    """(step, v') for float32 g, m, v of one shape: ``adam_scale_grouped``
    over a group of one."""
    if all(x.device.type in PLAIN_DEVICES for x in (g, m, v)):
        return adam_scale_plain(g, m, v, beta2, eps, bc1, bc2)
    steps, v_news = adam_scale_grouped([g], [m], [v], beta2, eps, bc1, bc2)
    return steps[0], v_news[0]


adam_scale.launches = 0
adam_scale.chunks = []  # the chunk of each launch of the last call on a card
