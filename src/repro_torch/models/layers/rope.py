"""Rotary position embeddings (standard RoPE).

Qwen2-VL's M-RoPE waits for the vlm family (ROADMAP item 11).
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
