"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE.

M-RoPE (arXiv:2409.12191) splits the head dim's rotary pairs into
sections driven by (temporal, height, width) position ids; text tokens
carry equal t/h/w ids, so on pure text it is RoPE.
"""

from __future__ import annotations

import torch


def _freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions: (..., S) int → angles (..., S, head_dim/2), float32."""
    return (positions[..., None].to(torch.float32)
            * _freqs(head_dim, theta, positions.device))


def mrope_angles(positions_thw: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple[int, ...]) -> torch.Tensor:
    """positions_thw: (3, B, S) int → angles (B, S, head_dim/2), float32.
    ``sections`` gives the rotary pairs each of t, h and w drives, in
    that order (they sum to head_dim/2): section i takes its frequencies
    from id row i."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim/2 = {head_dim // 2}")
    ang = (positions_thw[..., None].to(torch.float32)
           * _freqs(head_dim, theta, positions_thw.device))  # (3, B, S, hd/2)
    bounds = [0]
    for sec in sections:
        bounds.append(bounds[-1] + sec)
    return torch.cat([ang[i, ..., lo:hi] for i, (lo, hi) in
                      enumerate(zip(bounds, bounds[1:]))], dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); angles: (B, S, D/2) or (S, D/2).  Rotates the
    pairs (i, i + D/2) in float32; the result is in x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    x1, x2 = x.chunk(2, dim=-1)
    if angles.ndim == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)
