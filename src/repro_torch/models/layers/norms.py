"""Normalization layers (functional).

``rmsnorm`` goes through the RMSNorm kernel (``kernels.ops.rmsnorm``: the
CUDA kernel on the card, its plain version on the CPU). ``layernorm`` (the
sLSTM's output norm, with scale and bias) is plain PyTorch, as it is jnp
code in the reference, in fp32 with population variance. ``batchnorm``
normalises with the batch's own statistics and population variance
(``unbiased=False``, as ``jnp.var``) and keeps no running statistics, so it
is not ``nn.BatchNorm1d``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    return ops.rmsnorm(x, scale, eps)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype)


def batchnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=0, keepdim=True)
    var = torch.var(xf, dim=0, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype)
