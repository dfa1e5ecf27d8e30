"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default ``device=None`` means ``cuda`` and raises when no card is
visible, so a missing card is never silently replaced by the CPU.  ``meta``
builds tensors of shapes alone (the dry run, ``launch.dryrun``); no
kernel takes them.
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
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_devices(device=None) -> tuple[torch.device, ...]:
    """The devices ``device`` names, for the entry points that split a
    lane batch over several (``noc.sim.LaneGroups``): a sequence, each
    entry resolved (the CPU or a card may be named more than once);
    ``None`` or ``"cuda"`` without an index, every visible card
    (``cuda:0`` … ``cuda:n−1``, as the reference's ``jax.devices()``);
    anything else, that one device."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("no device given")
        return tuple(resolve_device(d) for d in device)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)
