"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``; the card unless the caller asks for
    the CPU.  A CUDA device without a card raises: no entry point falls back
    to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on the card by default, and torch.cuda.is_available() "
            "is False; pass device='cpu' to run it on the CPU"
        )
    return device
