"""Analytical launch-plan cost model for the CUDA kernels, sized against
Hopper's limits. Port of ``repro/tune/cost_model.py``.

The reference ranks Pallas block plans against a TPU's VMEM budget. The
port's kernels are built for fixed geometries, so a candidate here is a
launch shape one of them already takes, never another:

* B5 (``csrc/adam_step.cu``): the chunk of elements one block takes, a
  power of two from ``CHUNK_MIN`` to ``CHUNK_MAX`` (multiples of 4 x
  ``THREADS``; ``kernels/adam_step.py``), the one launch parameter chosen
  at run time;
* B4 (``csrc/matmul.cu``): its one geometry, 128 x 128 x 32 tiles in 4
  stages of 256 threads;
* B1-B3 (``csrc/flash_*.cu``): the geometry built for each (kernel, head
  width, dtype), as ``kernels/flash.py::launched_blocks`` describes it:
  route, rows a block owns, blocks a cluster.

Each geometry's shared memory (mirroring the kernels' ``constexpr``
formulas) and registers (``ptxas -v`` of the card's build, ``PTXAS_REGISTERS``;
a caller holding a fresher report passes its own) are held to the limits of
an H100 (NVIDIA's published figures): 132 SMs, 232,448 bytes of shared
memory a block (233,472 an SM), 65,536 registers an SM and 255 a thread,
2,048 threads an SM. A geometry over them costs ``inf``, and ``best_*``
refuses it. The estimate is the roofline of the work, stretched by the
tail of the last wave over the SMs, plus one launch:

    cost = max(flops / peak, bytes / HBM_BW) * ceil(w) / w + LAUNCH_S,
    w = blocks / (132 * blocks resident on an SM)

with the peaks and the HBM rate of ``launch/roofline.py`` and ``LAUNCH_S``
the ~5 us one launch costs on the card (PERF.md §5: 4.8-5.3 us).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.kernels.adam_step import CHUNK_MAX, CHUNK_MIN
from repro_torch.kernels.adam_step import THREADS as ADAM_THREADS
from repro_torch.kernels.flash import HEAD_DIMS as FLASH_HEAD_DIMS
from repro_torch.kernels.flash import padded_width
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS, PEAK_FLOPS_3XTF32

SMS = 132
SMEM_PER_BLOCK = 232_448  # bytes a block may opt into
SMEM_PER_SM = 233_472
REGS_PER_SM = 65_536
REGS_PER_THREAD = 255
THREADS_PER_SM = 2_048
BLOCKS_PER_SM = 32
LAUNCH_S = 5e-6
MIN_BLOCK = 8  # the reference's smallest tile side (its f32 sublane)

# registers a thread of each kernel, from ``ptxas -v`` of the sm_90a build
# (one NVIDIA H100 80GB HBM3; chip_smoke.py writes the report to
# chiprun_out/nvcc_log.txt): (kernel, head width, dtype) for B1-B3, B4's worst
# pair of transpose flags, B5
PTXAS_REGISTERS: Dict[tuple, int] = {
    ("flash_fwd", 16, "float32"): 73, ("flash_fwd", 32, "float32"): 111,
    ("flash_fwd", 64, "float32"): 158, ("flash_fwd", 128, "float32"): 231,
    ("flash_bwd_dq", 16, "float32"): 100, ("flash_bwd_dq", 32, "float32"): 126,
    ("flash_bwd_dq", 64, "float32"): 180, ("flash_bwd_dq", 128, "float32"): 230,
    ("flash_bwd_dkv", 16, "float32"): 80, ("flash_bwd_dkv", 32, "float32"): 128,
    ("flash_bwd_dkv", 64, "float32"): 189, ("flash_bwd_dkv", 128, "float32"): 249,
    ("flash_fwd", 16, "bfloat16"): 105, ("flash_fwd", 32, "bfloat16"): 117,
    ("flash_fwd", 64, "bfloat16"): 130, ("flash_fwd", 128, "bfloat16"): 160,
    ("flash_bwd_dq", 16, "bfloat16"): 121, ("flash_bwd_dq", 32, "bfloat16"): 123,
    ("flash_bwd_dq", 64, "bfloat16"): 139, ("flash_bwd_dq", 128, "bfloat16"): 172,
    ("flash_bwd_dkv", 16, "bfloat16"): 134, ("flash_bwd_dkv", 32, "bfloat16"): 163,
    ("flash_bwd_dkv", 64, "bfloat16"): 184, ("flash_bwd_dkv", 128, "bfloat16"): 255,
    ("matmul",): 254,
    ("adam_scale",): 80,
}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
_DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def _pow2_range(lo: int, hi: int) -> List[int]:
    out, b = [], lo
    while b <= hi:
        out.append(b)
        b *= 2
    return out


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def candidate_blocks(size: int, cap: Optional[int] = None) -> List[int]:
    """Power-of-two block sizes for one dimension of extent `size`: MIN_BLOCK
    up to the padded full extent (the full-tile plan is always a candidate)."""
    hi = max(MIN_BLOCK, _next_pow2(size))
    if cap is not None:
        hi = min(hi, max(MIN_BLOCK, cap))
    return _pow2_range(MIN_BLOCK, hi)


def adam_chunks() -> List[int]:
    """The chunks B5 takes: powers of two from CHUNK_MIN to CHUNK_MAX."""
    return _pow2_range(CHUNK_MIN, CHUNK_MAX)


# ---------------------------------------------------------------------------
# the limits
# ---------------------------------------------------------------------------


def _regs_alloc(regs: int) -> int:
    return -(-regs // 8) * 8  # registers are allocated in units of 8 a thread


def fits(geom: Dict) -> bool:
    """Whether one block of ``geom`` (``threads``, ``smem_bytes``,
    ``registers`` a thread) fits an SM of the card."""
    return (geom["smem_bytes"] <= SMEM_PER_BLOCK and geom["registers"] <= REGS_PER_THREAD
            and geom["threads"] <= 1024
            and geom["threads"] * _regs_alloc(geom["registers"]) <= REGS_PER_SM)


def resident_blocks(geom: Dict) -> int:
    """Blocks of ``geom`` that one SM holds at once (0 when one does not fit)."""
    if not fits(geom):
        return 0
    return min(BLOCKS_PER_SM, THREADS_PER_SM // geom["threads"],
               REGS_PER_SM // (geom["threads"] * _regs_alloc(geom["registers"])),
               SMEM_PER_SM // (geom["smem_bytes"] + 1024))  # 1 KB reserved a block


def launch_cost_s(work_s: float, blocks: int, geom: Dict) -> float:
    """``work_s`` stretched by the tail of the last wave, plus one launch;
    ``inf`` for a geometry over the card's limits."""
    per_wave = SMS * resident_blocks(geom)
    if per_wave == 0:
        return float("inf")
    if blocks == 0:
        return LAUNCH_S
    waves = blocks / per_wave
    return work_s * math.ceil(waves) / waves + LAUNCH_S


# ---------------------------------------------------------------------------
# B5: the fused Adam scale
# ---------------------------------------------------------------------------


def adam_geometry(registers: Optional[int] = None) -> Dict:
    return {"threads": ADAM_THREADS, "smem_bytes": 0,
            "registers": registers or PTXAS_REGISTERS[("adam_scale",)]}


def adam_plan_cost(elements: int, chunk: int, registers: Optional[int] = None) -> float:
    """Estimated seconds of one grouped B5 launch over ``elements``: g, m, v
    read and step, v' written (20 bytes an element) over HBM, one block per
    ``chunk``."""
    blocks = -(-int(elements) // chunk)
    return launch_cost_s(20.0 * elements / HBM_BW, blocks, adam_geometry(registers))


def best_adam_plan(elements: int, registers: Optional[int] = None) -> Dict:
    """argmin over ``adam_chunks()``; ties go to the larger chunk (fewer
    blocks)."""
    best, best_cost = None, float("inf")
    for chunk in adam_chunks():
        c = adam_plan_cost(elements, chunk, registers)
        if c < best_cost or (c == best_cost and best is not None and chunk > best):
            best, best_cost = chunk, c
    if best is None:
        raise ValueError(f"adam_scale: no chunk fits the card ({adam_geometry(registers)})")
    return {"chunk": best, "cost_s": best_cost, "backend": "cost_model"}


# ---------------------------------------------------------------------------
# B4: the grouped 3xTF32 matmul
# ---------------------------------------------------------------------------


def matmul_geometry(bm: int = 128, bn: int = 128, bk: int = 32, stages: int = 4,
                    threads: int = 256, registers: Optional[int] = None) -> Dict:
    """csrc/matmul.cu's tiles: a stage holds an A and a B tile, each stored
    K-major ([mn][bk + 4]) or MN-major ([bk][mn + 8]) as its transpose flag
    has it; the worst pair of flags (both K-major) sizes the shared memory."""
    tile = max(bm * (bk + 4), bk * (bm + 8))
    return {"block_m": bm, "block_n": bn, "block_k": bk, "stages": stages, "threads": threads,
            "smem_bytes": 4 * stages * 2 * tile,
            "registers": registers or PTXAS_REGISTERS[("matmul",)]}


def matmul_plan_cost(m: int, n: int, k: int, geom: Optional[Dict] = None) -> float:
    """Estimated seconds of one (m, k) x (k, n) float32 product at ``geom``:
    3xTF32 operations at the TF32 rate over three, A streamed once per
    column tile and B once per row tile."""
    geom = geom or matmul_geometry()
    gm, gn = -(-m // geom["block_m"]), -(-n // geom["block_n"])
    flops = 2.0 * m * n * k
    nbytes = 4.0 * (gn * m * k + gm * k * n + m * n)
    return launch_cost_s(max(flops / PEAK_FLOPS_3XTF32, nbytes / HBM_BW), gm * gn, geom)


def best_matmul_plan(m: int, n: int, k: int, registers: Optional[int] = None) -> Dict:
    """The one geometry the kernel is built for, with its cost; refused when
    it does not fit the card."""
    geom = matmul_geometry(registers=registers)
    cost = matmul_plan_cost(m, n, k, geom)
    if math.isinf(cost):
        raise ValueError(f"matmul: the built geometry does not fit the card: {geom}")
    return {**geom, "cost_s": cost, "backend": "cost_model"}


# ---------------------------------------------------------------------------
# B1-B3: flash attention
# ---------------------------------------------------------------------------


def _flash_smem(kernel: str, dh: int, dtype: str) -> int:
    """Dynamic shared memory a block of the kernel built for (dh, dtype),
    from its source's constexpr geometry."""
    if dtype == "bfloat16":
        tile = 64 * dh * 2  # TileGeom<DH>::BYTES: 64 rows of dh bf16
        if kernel == "flash_fwd":  # FwdBf16Geom: Q, 4 stages of K and V, the merge
            return 1024 + tile + 4 * 2 * tile + (4 + dh // 2) * 128 * 4 + 8 * (1 + 2 * 4)
        return 1024 + 2 * tile + 3 * (2 * tile + 1024) + 8 * (1 + 2 * 3)  # Bf16Geom
    if kernel == "flash_fwd":
        if dh >= 64:  # FwdF32Geom: Q, STAGES of K and V, each in two TF32 halves
            stages = 1 if dh > 64 else 2
            tile = 2 * 64 * dh * 4
            return 1024 + tile + 2 * stages * tile + 8 * (2 + 5 * stages + 2)
        ldk, ldv = dh + 4, dh + 8  # FwdGeom: Q, then per warp K, V buffers and P
        return 4 * 16 * ldk + 8 * (4 * 2 * 16 * (ldk + ldv) + 4 * 16 * 20)
    dkv = kernel == "flash_bwd_dkv"
    if dh > 64:  # BwdF32Geom: four halves, the transposed tile, stats, the sent tile
        dc = dh if dkv else dh // 2
        return (1024 + 4 * 64 * dh * 4 + 2 * dc * 64 * 4 + (2 * 64 * 4 if dkv else 0)
                + 64 * 64 * 4 + 64)
    tile, p = 4 * 16 * dh, 4 * 16 * 20  # BwdGeom<DH, float>
    fixed = 4 * 2 * (dh // 8) * 2 * 32 * 4
    warp = 4 * tile + (4 * 4 * 16 + 2 * p if dkv else p)
    return fixed + 8 * warp


def flash_geometry(kernel: str, dh: int, dtype: str = "float32",
                   registers: Optional[int] = None) -> Dict:
    """The launch geometry built for ``kernel`` at head width ``dh`` and
    ``dtype`` (``launched_blocks``' description): its source, route, rows a
    cluster owns, blocks a cluster, threads a block, shared memory and
    registers."""
    if kernel not in FLASH_KERNELS or dh not in FLASH_HEAD_DIMS or dtype not in _DTYPE_BYTES:
        raise ValueError(f"no flash kernel is built for {kernel} at dh {dh} in {dtype}")
    regs = registers or PTXAS_REGISTERS[(kernel, dh, dtype)]
    smem = _flash_smem(kernel, dh, dtype)
    fwd = kernel == "flash_fwd"
    if dtype == "bfloat16":
        return {"source": "flash_fwd_bf16.cu" if fwd else "flash_bwd_bf16.cu", "route": "wgmma",
                "rows": 64, "cluster": 1, "threads": 288 if fwd else 160,
                "smem_bytes": smem, "registers": regs}
    if fwd and dh >= 64:
        return {"source": "flash_fwd_f32.cu", "route": "wgmma", "rows": 64,
                "cluster": 2 if dh > 64 else 4, "threads": 256, "smem_bytes": smem,
                "registers": regs}
    if not fwd and dh > 64:
        return {"source": "flash_bwd_f32.cu", "route": "wgmma", "rows": 64, "cluster": 2,
                "threads": 256, "smem_bytes": smem, "registers": regs}
    return {"source": "flash_fwd.cu" if fwd else "flash_bwd.cu", "route": "mma.sync",
            "rows": 16, "cluster": 1, "threads": 256, "smem_bytes": smem, "registers": regs}


def flash_blocks(geom: Dict, S: int, batch_heads: int) -> int:
    """Blocks of one launch: a cluster per ``rows`` rows of each head."""
    return batch_heads * -(-S // geom["rows"]) * geom["cluster"]


def flash_kernel_cost(kernel: str, S: int, dh: int, *, batch_heads: int = 1,
                      dtype: str = "float32", causal: bool = True,
                      geom: Optional[Dict] = None) -> float:
    """Estimated seconds of one launch of ``kernel``: its products over the
    visible entries (float32 in 3xTF32, bf16 on the bf16 rate with B1's P V
    in two passes), each input read once and each output written once."""
    geom = geom or flash_geometry(kernel, dh, dtype)
    entries = S * (S + 1) // 2 if causal else S * S
    prod = 2.0 * dh * entries * batch_heads  # one (S x S) by (S x dh) product
    head, row = float(_DTYPE_BYTES[dtype]) * batch_heads * S * dh, 4.0 * batch_heads * S
    flops, nbytes = {"flash_fwd": (2 * prod, 4 * head + row),
                     "flash_bwd_dq": (3 * prod, 5 * head + 2 * row),
                     "flash_bwd_dkv": (4 * prod, 6 * head + 2 * row)}[kernel]
    if dtype == "bfloat16":
        peak = PEAK_FLOPS
        if kernel == "flash_fwd":
            flops += prod  # P V as P's hi and lo bf16 parts
    else:
        peak = PEAK_FLOPS_3XTF32
    return launch_cost_s(max(flops / peak, nbytes / HBM_BW),
                         flash_blocks(geom, S, batch_heads), geom)


def best_flash_plan(S: int, dh: int, *, batch_heads: int = 1, dtype: str = "float32",
                    causal: bool = True, registers: Optional[Dict[str, int]] = None) -> Dict:
    """The geometries built for (dh, dtype), forward plus backward, with
    their summed cost; refused when any does not fit the card. A head width
    outside the built ones is costed at the width it is padded to."""
    width = padded_width(dh)
    plan: Dict = {"head_dim": width, "cost_s": 0.0, "backend": "cost_model"}
    for kernel in FLASH_KERNELS:
        geom = flash_geometry(kernel, width, dtype, (registers or {}).get(kernel))
        cost = flash_kernel_cost(kernel, S, width, batch_heads=batch_heads, dtype=dtype,
                                 causal=causal, geom=geom)
        if math.isinf(cost):
            raise ValueError(f"{kernel}: the geometry built for dh {width} in {dtype} does "
                             f"not fit the card: {geom}")
        plan[kernel] = {**geom, "blocks": flash_blocks(geom, S, batch_heads), "cost_s": cost}
        plan["cost_s"] += cost
    return plan
