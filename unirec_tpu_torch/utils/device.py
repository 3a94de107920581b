"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The entry points' device rule: the CUDA card unless the caller asks
    for another device (``device="cpu"``); asking for the card, or asking
    for nothing, where there is none raises."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' (--device cpu on the command "
            "line) to run on the CPU")
    return device
