"""Fused second-moment / step update of the rotated Adam.

Port of ``repro/kernels/adam_step.py::fused_adam_scale`` (Pallas
``_adam_kernel``). The CUDA kernel is ``csrc/adam_step.cu``. ``adam_scale``
dispatches on the tensors' device: CPU tensors take ``adam_scale_plain``,
CUDA tensors launch the kernel or raise.

Computes, in float32:
    v'   = b2 * v + (1 - b2) * g^2
    step = (m / bc1) / (sqrt(v' / bc2) + eps)
and returns (step, v'). As in the reference kernel, the scalars are float32
and (1 - b2) is formed from float32 b2.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.build import check, load_library

Tensor = torch.Tensor


def _scalars(beta2, eps, bc1, bc2):
    b2 = np.float32(beta2)
    return (float(b2), float(np.float32(1) - b2), float(np.float32(eps)),
            float(np.float32(bc1)), float(np.float32(bc2)))


def adam_scale_plain(g: Tensor, m: Tensor, v: Tensor, beta2: float, eps: float,
                     bc1: float, bc2: float) -> Tuple[Tensor, Tensor]:
    """The kernel's plain PyTorch version, in the kernel's operation order."""
    b2, omb2, eps, bc1, bc2 = _scalars(beta2, eps, bc1, bc2)
    g, m, v = g.float(), m.float(), v.float()
    v_new = b2 * v + omb2 * g * g
    step = (m / bc1) / (torch.sqrt(v_new / bc2) + eps)
    return step, v_new


def adam_scale(g: Tensor, m: Tensor, v: Tensor, beta2: float, eps: float,
               bc1: float, bc2: float) -> Tuple[Tensor, Tensor]:
    """(step, v') for float32 g, m, v of one shape; scalars are host floats."""
    if g.device.type == "cpu" and m.device.type == "cpu" and v.device.type == "cpu":
        return adam_scale_plain(g, m, v, beta2, eps, bc1, bc2)
    if not (g.is_cuda and g.device == m.device == v.device):
        raise ValueError(f"adam_scale: tensors on {g.device}, {m.device}, {v.device}")
    if not (g.dtype == m.dtype == v.dtype == torch.float32):
        raise TypeError(f"adam_scale: float32 only, got {g.dtype}, {m.dtype}, {v.dtype}")
    if not (g.shape == m.shape == v.shape):
        raise ValueError(f"adam_scale: shapes differ {g.shape}, {m.shape}, {v.shape}")
    if not (g.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
        raise ValueError("adam_scale: tensors must be contiguous")
    step = torch.empty_like(g)
    v_new = torch.empty_like(g)
    if g.numel() == 0:
        return step, v_new
    b2, _, eps, bc1, bc2 = _scalars(beta2, eps, bc1, bc2)
    lib = load_library().lib
    stream = torch.cuda.current_stream(g.device).cuda_stream
    check(lib.rbr_adam_scale_f32(g.data_ptr(), m.data_ptr(), v.data_ptr(),
                                 step.data_ptr(), v_new.data_ptr(), g.numel(),
                                 b2, eps, bc1, bc2, g.device.index, stream),
          "adam_scale")
    adam_scale.launches += 1
    return step, v_new


adam_scale.launches = 0
