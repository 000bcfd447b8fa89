"""Contrastive losses: InfoNCE (paper Eq. 2) and representation alignment
(paper Eq. 3), and the SimCLR and BYOL objectives (``repro.core.losses``).

Both take (B, d) vectors with in-batch negatives, in fp32. As in the JAX
package's ``ops.fused_info_nce``, the rows are L2-normalised in plain
PyTorch and the per-row loss is the InfoNCE kernel
(``kernels.ops.info_nce_rows``: the CUDA forward and gradient kernels on
the card, their plain versions on the CPU), under ``vmap`` too.
``simclr_nt_xent`` and ``byol_regression`` are plain PyTorch, as they are
jnp code in the reference: NT-Xent's (2B, 2B) logits carry a self-mask
that the InfoNCE kernel does not compute.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels import ops
from repro_torch.sharding.aten import LOSS, collective_source


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    xf = x.to(torch.float32)
    return xf / torch.clamp(torch.linalg.vector_norm(xf, dim=-1,
                                                     keepdim=True), min=eps)


def _replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated on its mesh (``t`` itself if plain), before
    the norm: the InfoNCE op runs replicated (its sharding rule), and the
    norm's backward on a vector split over its feature dim would write in
    place into a partial sum, which DTensor refuses."""
    if isinstance(t, DTensor):
        with collective_source(LOSS):
            return t.redistribute(t.device_mesh,
                                  [Replicate()] * t.device_mesh.ndim)
    return t


def info_nce(q: torch.Tensor, k: torch.Tensor, tau: float) -> torch.Tensor:
    """InfoNCE with in-batch negatives (Eq. 2): mean over rows of
    logsumexp_j(q_i k_j / tau) - q_i k_i / tau. No 2*tau factor (see
    ``moco_contrastive``)."""
    q, k = _replicated(q), _replicated(k)
    return torch.mean(ops.info_nce_rows(l2_normalize(q), l2_normalize(k),
                                        tau))


def moco_contrastive(q1, k2, q2, k1, tau: float) -> torch.Tensor:
    """Symmetrized MoCo v3 loss l(q1,k2) + l(q2,k1) (Algorithm 2 line 11).
    MoCo v3 scales it by 2*tau; the reference keeps the plain sum."""
    return info_nce(q1, k2.detach(), tau) + info_nce(q2, k1.detach(), tau)


def align_loss(z1_local, z2_global, z2_local, z1_global,
               tau: float) -> torch.Tensor:
    """Representation alignment (Eq. 3), symmetrized (Algorithm 2 line 12):
    l(z1_i, z2) + l(z2_i, z1) against the frozen global encoder."""
    return info_nce(z1_local, z2_global.detach(), tau) + \
        info_nce(z2_local, z1_global.detach(), tau)


def byol_regression(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """BYOL: mean over rows of |q/|q| - k/|k||^2 (2 - 2 cos); no gradient
    reaches k."""
    q = l2_normalize(q)
    k = l2_normalize(k)
    return torch.mean(torch.sum((q - k.detach()) ** 2, dim=-1))


def simclr_nt_xent(z1: torch.Tensor, z2: torch.Tensor,
                   tau: float) -> torch.Tensor:
    """NT-Xent over the 2B views: row i's positive is row i + B (mod 2B),
    every other row a negative. The self-logits are masked by subtracting
    1e9, as the reference does (not -inf), so the loss is its bits."""
    B = z1.shape[0]
    z = l2_normalize(torch.cat([z1, z2], dim=0))            # (2B, d)
    logits = (z @ z.T) / tau
    logits = logits - 1e9 * torch.eye(2 * B, dtype=logits.dtype,
                                      device=logits.device)
    labels = torch.cat([torch.arange(B, device=z.device) + B,
                        torch.arange(B, device=z.device)])
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[:, None], dim=-1)[:, 0]
    return torch.mean(logz - gold)
