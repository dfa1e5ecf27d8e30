"""Public ops: the possibility passes, dispatched by the device of their
inputs.

Tensors on the card go through the CUDA kernels; tensors on the CPU go
through the plain versions.  The two never stand in for each other.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from .kernel import possibility_v_cuda, possibility_weights_cuda
from .ref import possibility_v_plain, possibility_weights_plain


def _same_device(**xs) -> torch.device:
    devs = {x.device for x in xs.values()}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_dtypes(**xs) -> None:
    for name, (x, dt) in xs.items():
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")


def _check(du, dn, t, dist):
    n, c = du.shape
    if dn.shape != (c, n) or t.shape != (n, n) or dist.shape != (n, n):
        raise ValueError(f"shape mismatch: du {tuple(du.shape)}, dn "
                         f"{tuple(dn.shape)}, t {tuple(t.shape)}, dist "
                         f"{tuple(dist.shape)}")
    _check_dtypes(du=(du, torch.int32), dn=(dn, torch.int32),
                  dist=(dist, torch.int32))
    _same_device(du=du, dn=dn, t=t, dist=dist)


def possibility_v(du: torch.Tensor, dn: torch.Tensor, t: torch.Tensor,
                  dist: torch.Tensor, offset: int = 1) -> torch.Tensor:
    """``V[c, d] = Σ_s T[s,d]·[du[s,c] + offset + dn[c,d] == dist[s,d]]``
    — du (N, C), dn (C, N), dist (N, N) int32; t (N, N) → V (C, N)."""
    _check(du, dn, t, dist)
    if du.device.type == "cpu":
        return possibility_v_plain(du, dn, t, dist, offset)
    if t.dtype != torch.float64:
        raise TypeError(f"the kernel sums in fp64; t is {t.dtype}")
    if not all(x.is_contiguous() for x in (du, dn, t, dist)):
        raise ValueError("the kernel takes contiguous inputs")
    return possibility_v_cuda(du, dn, t, dist, offset)


def possibility_weights_op(du: torch.Tensor, dn: torch.Tensor,
                           dsn: torch.Tensor, tn: torch.Tensor,
                           t: torch.Tensor, dist: torch.Tensor,
                           offset: int = 1
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, W_drn), each (C,) float32, from the prepared gathers: du, dsn
    (N, C) and dn (C, N) int32, tn (N, C) and t (N, N) float32, dist
    (N, N) int32 (see :func:`possibility_weights`)."""
    n, c = du.shape
    shapes = {"du": (du, (n, c)), "dn": (dn, (c, n)), "dsn": (dsn, (n, c)),
              "tn": (tn, (n, c)), "t": (t, (n, n)), "dist": (dist, (n, n))}
    bad = {k: tuple(x.shape) for k, (x, s) in shapes.items()
           if tuple(x.shape) != s}
    if bad:
        raise ValueError(f"shape mismatch for N={n}, C={c}: {bad}")
    _check_dtypes(du=(du, torch.int32), dn=(dn, torch.int32),
                  dsn=(dsn, torch.int32), dist=(dist, torch.int32),
                  tn=(tn, torch.float32), t=(t, torch.float32))
    dev = _same_device(du=du, dn=dn, dsn=dsn, tn=tn, t=t, dist=dist)
    if dev.type == "cpu":
        return possibility_weights_plain(du, dn, dsn, tn, t, dist, offset)
    if not all(x.is_contiguous() for x in (du, dn, dsn, tn, t, dist)):
        raise ValueError("the kernel takes contiguous inputs")
    return possibility_weights_cuda(du, dn, dsn, tn, t, dist, offset)


def prepare_weights(dist, traffic, channels, device=None):
    """The reference op's host gathers (``ops._prepare``), as tensors on
    ``device``: du, dn, dsn (int32), tn, t (float32), dist (int32)."""
    dev = resolve_device(device)
    channels = np.asarray(channels)
    us, ns = channels[:, 0], channels[:, 1]
    dist = np.asarray(dist, np.int32)
    t = np.asarray(traffic, np.float32)
    arrays = (dist[:, us], dist[ns, :], dist[:, ns], t[:, ns], t, dist)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in arrays)


def possibility_weights(dist, traffic, channels, offset: int = 1,
                        device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, W_drn) per channel, each (C,) float32 on ``device`` (default:
    the card) — eq. 5/7 (``offset=1``) or the k-hop continuation
    predicate (``offset=2`` for consecutive pairs, where W_drn carries
    no meaning).  ``channels`` is a (C, 2) array of (u, n) node pairs;
    traffic is read as float32, as the reference op reads it."""
    return possibility_weights_op(
        *prepare_weights(dist, traffic, channels, device), offset=offset)
