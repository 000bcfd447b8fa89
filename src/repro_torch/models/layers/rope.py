"""Rotary position embeddings, split-half form (``repro.models.layers.rope``:
the first and second halves of the head dim are the two rotated
components, not interleaved pairs)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)                  # (head_dim // 2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S). fp32 math, output in
    x's dtype."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.to(torch.float32)[..., :, None] * inv    # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
