"""Public op: the possibility pass, dispatched by the device of its inputs.

Tensors on the card go through the CUDA kernel (fp64 only); tensors on
the CPU go through the plain version.  The two never stand in for each
other.
"""

from __future__ import annotations

import torch

from .kernel import possibility_v_cuda
from .ref import possibility_v_plain


def _check(du, dn, t, dist):
    n, c = du.shape
    if dn.shape != (c, n) or t.shape != (n, n) or dist.shape != (n, n):
        raise ValueError(f"shape mismatch: du {tuple(du.shape)}, dn "
                         f"{tuple(dn.shape)}, t {tuple(t.shape)}, dist "
                         f"{tuple(dist.shape)}")
    for name, x, dt in (("du", du, torch.int32), ("dn", dn, torch.int32),
                        ("dist", dist, torch.int32)):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
    devs = {x.device for x in (du, dn, t, dist)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def possibility_v(du: torch.Tensor, dn: torch.Tensor, t: torch.Tensor,
                  dist: torch.Tensor, offset: int = 1) -> torch.Tensor:
    """``V[c, d] = Σ_s T[s,d]·[du[s,c] + offset + dn[c,d] == dist[s,d]]``
    — du (N, C), dn (C, N), dist (N, N) int32; t (N, N) → V (C, N)."""
    _check(du, dn, t, dist)
    if du.device.type == "cpu":
        return possibility_v_plain(du, dn, t, dist, offset)
    if du.device.type != "cuda":
        raise ValueError(f"unsupported device {du.device}")
    if t.dtype != torch.float64:
        raise TypeError(f"the kernel sums in fp64; t is {t.dtype}")
    if not all(x.is_contiguous() for x in (du, dn, t, dist)):
        raise ValueError("the kernel takes contiguous inputs")
    return possibility_v_cuda(du, dn, t, dist, offset)
