"""Plain-torch possibility passes: the CPU path and the kernels' yardstick.

    V[c, d] = Σ_s T[s,d] · [du[s,c] + offset + dn[c,d] == dist[s,d]]

the dense reformulation of the reference's chunked jnp pass
(``plan_fast._possibility_v`` with ``use_pallas=False``): a (B, N, N)
mask per channel block, contracted against T.  The same mask summed
over d as well gives eq. 5's W (:func:`possibility_weights_plain`).
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


def possibility_weights_plain(du: torch.Tensor, dn: torch.Tensor,
                              dsn: torch.Tensor, tn: torch.Tensor,
                              t: torch.Tensor, dist: torch.Tensor,
                              offset: int = 1
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """du, dsn (N, C) int32, dn (C, N) int32, tn (N, C) float32, t (N, N)
    float32, dist (N, N) int32 → (W, W_drn), each (C,) float32:

        W[c]     = Σ_{s,d} T[s,d] · [du[s,c] + offset + dn[c,d] == dist[s,d]]
        W_drn[c] = Σ_s    tn[s,c] · [du[s,c] + offset == dsn[s,c]]

    the reference's dense pass (``possibility_weights_dense``) with the
    kernel's arithmetic: fp64 sums, one rounding to float32."""
    n, c = du.shape
    t64 = t.to(torch.float64)
    w = torch.empty(c, dtype=torch.float64, device=t.device)
    blk = _block(n)
    for lo in range(0, c, blk):
        hi = min(lo + blk, c)
        lhs = du[:, lo:hi].T[:, :, None] + offset + dn[lo:hi, None, :]
        mask = (lhs == dist[None]).to(torch.float64)
        w[lo:hi] = torch.einsum("bsd,sd->b", mask, t64)
    drn = ((du + offset) == dsn).to(torch.float64)
    w_drn = torch.einsum("sc,sc->c", drn, tn.to(torch.float64))
    return w.to(torch.float32), w_drn.to(torch.float32)
