"""Roofline terms of one step, from what a trace on the meta device counted.
Port of ``repro/launch/roofline.py``.

Hardware model: one NVIDIA H100 SXM 80 GB (the H100's data sheet): 989
TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3, NVLink 4 at 450
GB/s per direction. Beside them: 67 TFLOP/s float32 outside the tensor
cores (what a float32 ``torch.matmul`` runs at with TF32 off, as the port
runs it), 495 TFLOP/s TF32 and 165 TFLOP/s for float32 products split into
three TF32 passes (3xTF32, the route of the port's float32 kernels). The
three terms (seconds, per card):

    compute    = FLOPs / the peak of the step's compute dtype
    memory     = HBM bytes / 3.35e12
    collective = collective bytes / 450e9

``repro_torch.launch.dryrun`` counts the FLOPs (``FlopCounterMode``) and the
bytes each operation reads and writes (a dispatch mode) while the step runs
on the meta device, and reckons the collective bytes from the grid; there
is no compiled artifact to read them from, so ``roofline_from_trace`` takes
the counts. ``CARD_PEAKS`` holds the published figures of the three H100
parts by the words their device names carry.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

PEAK_FLOPS = 989e12  # dense bf16 per card
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s per direction (18 NVLink 4 links)
ICI_BW = NVLINK_BW  # the reference's name for the inter-chip link's rate

PEAK_FLOPS_F32 = 67e12  # float32 FMA outside the tensor cores
PEAK_FLOPS_TF32 = 495e12  # dense TF32 on the tensor cores
TF32_PASSES = 3  # the 3xTF32 split: three tensor-core products per float32 product
PEAK_FLOPS_3XTF32 = PEAK_FLOPS_TF32 / TF32_PASSES

# Published dense peaks (NVIDIA data sheets) by the part named in the
# device's name: float32 outside the tensor cores, device memory bandwidth,
# TF32 and bf16 on the tensor cores. The SXM part is the default.
CARD_PEAKS: Dict[str, Tuple[float, float, float, float]] = {
    "PCIe": (51.2e12, 2.0e12, 378e12, 756e12),
    "NVL": (60.0e12, 3.9e12, 417.5e12, 835e12),
    "SXM": (PEAK_FLOPS_F32, HBM_BW, PEAK_FLOPS_TF32, PEAK_FLOPS),
}
CARD_BYTES = 80 * 10 ** 9  # device memory of the H100 SXM 80 GB, as the data sheet gives it


def card_peaks(name: str) -> Tuple[str, Tuple[float, float, float, float]]:
    """(part, peaks) for a device name such as ``torch.cuda.get_device_name``."""
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return key, peaks
    return "SXM", CARD_PEAKS["SXM"]


def peak_flops_for(dtype: str) -> float:
    """The compute peak of a step whose products run in ``dtype``
    (``ModelConfig.dtype``): bf16 on the tensor cores, float32 outside them."""
    return PEAK_FLOPS if dtype == "bfloat16" else PEAK_FLOPS_F32


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    peak_memory_bytes: float = 0.0
    model_flops: float = 0.0
    collectives: Optional[Dict[str, int]] = None

    @property
    def step_time_s(self) -> float:
        # optimistic overlap model: terms overlap perfectly
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def row(self) -> Dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "peak_memory_bytes": self.peak_memory_bytes,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "collectives": self.collectives or {},
        }


def roofline_from_trace(flops: float, hbm_bytes: float, collectives: Dict[str, int],
                        peak_memory_bytes: float = 0.0, model_flops: float = 0.0,
                        peak_flops: float = PEAK_FLOPS) -> Roofline:
    """The roofline of a traced step: its counted FLOPs and HBM bytes, its
    collective bytes by operation (``{"all-reduce": bytes}``), its peak of
    live bytes, at ``peak_flops`` (``peak_flops_for`` the compute dtype)."""
    coll = float(sum(collectives.values()))
    compute_s = flops / peak_flops
    memory_s = hbm_bytes / HBM_BW
    coll_s = coll / ICI_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    return Roofline(
        flops=float(flops),
        hbm_bytes=float(hbm_bytes),
        collective_bytes=coll,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=coll_s,
        bottleneck=max(terms, key=terms.get),
        peak_memory_bytes=float(peak_memory_bytes),
        model_flops=model_flops,
        collectives=dict(collectives),
    )


def ring_all_reduce_bytes(nbytes: float, ranks: int) -> float:
    """Bytes each rank sends in a ring all-reduce of ``nbytes`` over
    ``ranks`` ranks: a reduce-scatter and an all-gather, each (ranks - 1) /
    ranks of the buffer."""
    return 2.0 * (ranks - 1) / ranks * nbytes if ranks > 1 else 0.0


def dense_model_flops(n_params: int, tokens: int, mode: str = "train") -> float:
    """6*N*D for training; 2*N*D for a forward/decode pass."""
    mult = 6.0 if mode == "train" else 2.0
    return mult * n_params * tokens
