"""Feed-forward layers: the SwiGLU and GELU MLPs
(``repro.models.layers.mlp``).

``jax.nn.gelu`` defaults to the tanh approximation, so GELU here is
``F.gelu(approximate="tanh")``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mlp_shapes(d_model: int, d_ff: int, act: str = "swiglu"):
    """Per-layer leaf shapes: ``w_up``, ``w_down`` and, for SwiGLU,
    ``w_gate``."""
    shapes = {"w_down": (d_ff, d_model), "w_up": (d_model, d_ff)}
    if act == "swiglu":
        shapes["w_gate"] = (d_model, d_ff)
    return shapes


def mlp_apply(p, x: torch.Tensor, act: str = "swiglu",
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """p: {"w_up", "w_down"} (+ "w_gate" for SwiGLU); x: (..., d).
    SwiGLU is ``silu(x w_gate) * (x w_up)``, GELU ``gelu(x w_up)``."""
    xc = x.to(compute_dtype)
    up = xc @ p["w_up"].to(compute_dtype)
    if act == "swiglu":
        h = F.silu(xc @ p["w_gate"].to(compute_dtype)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return (h @ p["w_down"].to(compute_dtype)).to(x.dtype)
