"""Plain-torch possibility pass: the CPU path and the kernel's yardstick.

    V[c, d] = Σ_s T[s,d] · [du[s,c] + offset + dn[c,d] == dist[s,d]]

the dense reformulation of the reference's chunked jnp pass
(``plan_fast._possibility_v`` with ``use_pallas=False``): a (B, N, N)
mask per channel block, contracted against T.
"""

from __future__ import annotations

import torch


def _block(n: int) -> int:
    """Channels per block: keeps one block's (B, N, N) mask near 16 M
    elements."""
    return int(max(1, min(256, (1 << 24) // max(n * n, 1))))


def possibility_v_plain(du: torch.Tensor, dn: torch.Tensor,
                        t: torch.Tensor, dist: torch.Tensor,
                        offset: int = 1) -> torch.Tensor:
    """du (N, C) int32, dn (C, N) int32, t (N, N) float, dist (N, N)
    int32 → V (C, N) in t's dtype."""
    n, c = du.shape
    out = torch.empty((c, n), dtype=t.dtype, device=t.device)
    blk = _block(n)
    for lo in range(0, c, blk):
        hi = min(lo + blk, c)
        lhs = du[:, lo:hi].T[:, :, None] + offset + dn[lo:hi, None, :]
        mask = (lhs == dist[None]).to(t.dtype)
        out[lo:hi] = torch.einsum("bsd,sd->bd", mask, t)
    return out
