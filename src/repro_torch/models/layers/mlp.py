"""Feed-forward layer: the GELU MLP of the ViT block
(``repro.models.layers.mlp``; its SwiGLU form comes with the LM slice).

``jax.nn.gelu`` defaults to the tanh approximation, so GELU here is
``F.gelu(approximate="tanh")``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mlp_apply(p, x: torch.Tensor,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """p: {"w_up", "w_down"}; x: (..., d)."""
    xc = x.to(compute_dtype)
    h = F.gelu(xc @ p["w_up"].to(compute_dtype), approximate="tanh")
    return (h @ p["w_down"].to(compute_dtype)).to(x.dtype)
