"""Each rank's device and the transport between ranks, chosen once from the
layout. Counterpart of ``repro/launch/devices.py``, which forces XLA host
devices before jax starts; that has no meaning in torch. Here the two
choices a multi-process run makes before its first tensor are:

* **Each rank's device**: rank r computes on ``cuda:(r % device_count)``,
  or on the CPU under ``--device cpu``. A rank never moves to the CPU
  because it finds no card: ``launch.train.resolve_device`` raises.
* **The transport**: with a card per rank, NCCL, device to device. With
  ranks that share a card, or on the CPU, gloo: point-to-point tensors are
  copied to host buffers by the transport (gloo's ``send`` / ``recv`` take
  CPU tensors only) and sums are handed to gloo. NCCL refuses two ranks of
  one communicator on one device, so asking for it there is refused by
  name. The choice is never switched on an error, and no other is offered:
  each layout has one transport that runs it.
"""
from __future__ import annotations

from typing import Tuple

import torch

TRANSPORTS = ("auto", "nccl")


def rank_device(kind: str, process_index: int) -> torch.device:
    """Rank ``process_index``'s device: ``cuda:(r % device_count)`` for
    ``kind == "cuda"`` (raising when there is no card), else the CPU."""
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    return torch.device("cuda", process_index % torch.cuda.device_count())


def choose_transport(device: torch.device, num_processes: int,
                     asked: str = "auto") -> Tuple[str, bool, str]:
    """(backend, host-staged, why) for ``num_processes`` ranks on
    ``device``'s kind of device. ``asked`` is ``auto`` or ``nccl``, which
    asserts a card per rank: it raises where ranks share a card or run on
    the CPU."""
    if asked not in TRANSPORTS:
        raise ValueError(f"unknown transport {asked!r}; one of {TRANSPORTS}")
    if device.type == "cpu":
        if asked == "nccl":
            raise ValueError("--transport nccl needs a card per rank; these ranks run on the CPU")
        return "gloo", False, "ranks on the CPU"
    cards = torch.cuda.device_count()
    if num_processes > cards:
        if asked == "nccl":
            raise ValueError(
                f"--transport nccl refused: {num_processes} ranks share {cards} card(s), and "
                "NCCL refuses two ranks of one communicator on one device")
        return "gloo", True, f"{num_processes} ranks share {cards} card(s)"
    return "nccl", False, f"one card per rank ({num_processes} ranks, {cards} cards)"
