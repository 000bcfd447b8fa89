"""MoCo v3 MLP heads (paper Tables B.7 / B.8; ``repro.core.heads``).

Projection head H: 3-layer MLP, hidden 4096, out 256, BN + ReLU after the
hidden layers, BN (no ReLU) on the output layer. Prediction head P: 2-layer
MLP, hidden 4096, out 256. BatchNorm uses the local batch's statistics
(``layers.norms.batchnorm``). Head parameters are flat dicts
``{"layers/<i>/w", "layers/<i>/bn/scale", "layers/<i>/bn/bias"}``.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from repro_torch.models.layers.init import dense_init_
from repro_torch.models.layers.norms import batchnorm
from repro_torch.models.params import ParamTree


def head_shapes(dims: Sequence[int]) -> Dict[str, tuple]:
    shapes = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        shapes[f"layers/{i}/bn/bias"] = (b,)
        shapes[f"layers/{i}/bn/scale"] = (b,)
        shapes[f"layers/{i}/w"] = (a, b)
    return shapes


def proj_dims(d_in: int, hidden: int, out: int):
    return (d_in, hidden, hidden, out)


def pred_dims(d_in: int, hidden: int, out: int):
    return (d_in, hidden, out)


def head_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """x: (B, d_in) -> (B, d_out). ReLU on all but the last layer."""
    n = sum(1 for k in params if k.endswith("/w"))
    for i in range(n):
        x = x.to(torch.float32) @ params[f"layers/{i}/w"].to(torch.float32)
        x = batchnorm(x, params[f"layers/{i}/bn/scale"],
                      params[f"layers/{i}/bn/bias"], eps)
        if i < n - 1:
            x = F.relu(x)
    return x


class MLPHead(ParamTree):
    def __init__(self, dims: Sequence[int], dtype=torch.float32,
                 device="meta"):
        super().__init__(head_shapes(dims), dtype, device)
        self.dims = tuple(dims)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            for i, a in enumerate(self.dims[:-1]):
                dense_init_(self.p(f"layers/{i}/w"), a, generator)
                self.p(f"layers/{i}/bn/scale").fill_(1.0)
                self.p(f"layers/{i}/bn/bias").zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return head_apply({k: self.p(k) for k in head_shapes(self.dims)}, x)


def init_head(dims, generator=None, device="cpu", dtype=torch.float32):
    head = MLPHead(dims, dtype, device)
    head.reset_parameters(generator)
    return {k: t.detach() for k, t in head.flat_params().items()}
