"""Weight initializers (the port's counterparts of
``repro.models.layers.init``; draws come from an explicit generator)."""
from __future__ import annotations

import math

import torch


def dense_init_(t: torch.Tensor, fan_in: int, generator=None,
                scale: float = 1.0) -> torch.Tensor:
    """In place: truncated normal on [-2, 2] standard deviations, times
    ``scale / sqrt(fan_in)`` (LeCun fan-in)."""
    with torch.no_grad():
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return t.mul_(scale / math.sqrt(fan_in))


def embed_init_(t: torch.Tensor, generator=None,
                std: float = 0.02) -> torch.Tensor:
    with torch.no_grad():
        return torch.nn.init.normal_(t, 0.0, std, generator=generator)
