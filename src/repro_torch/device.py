"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default ``device=None`` means ``cuda`` and raises when no card is
visible, so a missing card is never silently replaced by the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); else the device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the "
            "plain-torch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
