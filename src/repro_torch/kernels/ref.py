"""Plain PyTorch versions of the port's kernels (ported from
``src/repro/kernels/ref.py``).

The CPU path runs these, the tests hold them against the JAX package, and
``chip_smoke.py`` holds each CUDA kernel against them on the card. The
backward functions are the closed-form gradients the autograd Functions in
``ops.py`` use on every device.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

NEG_INF = -1e30


# -- wire pack / unpack -------------------------------------------------------
def wire_pack_ref(srcs: Sequence[torch.Tensor],
                  layout: Sequence[Tuple[int, int, int]],
                  total: int) -> torch.Tensor:
    """Slot-table gather: layout rows are (src_off, dst_off, size)."""
    out = torch.zeros(total, dtype=torch.float32, device=srcs[0].device)
    for src, (src_off, dst_off, size) in zip(srcs, layout):
        out[dst_off:dst_off + size] = \
            src.reshape(-1)[src_off:src_off + size].to(torch.float32)
    return out


def wire_unpack_ref(flat: torch.Tensor, bases: Sequence[torch.Tensor],
                    layout: Sequence[Tuple[int, int, int]]
                    ) -> List[torch.Tensor]:
    """Slot-table scatter into copies: each slot range of ``flat``
    overwrites the matching range of a copy of its base leaf (read
    raveled; the copy keeps the base's shape)."""
    outs = []
    for base, (src_off, dst_off, size) in zip(bases, layout):
        out = base.clone(memory_format=torch.contiguous_format)
        out.view(-1)[src_off:src_off + size] = \
            flat[dst_off:dst_off + size].to(base.dtype)
        outs.append(out)
    return outs


# -- RMSNorm -----------------------------------------------------------------
def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-5):
    """Gradients of ``rmsnorm_ref`` wrt (x, scale), recomputed from x:
    gx = r (gy - x_hat mean(gy x_hat)), gscale = sum(g x_hat) with
    r = rsqrt(mean(x^2) + eps), x_hat = x r, gy = g scale."""
    xf = x.to(torch.float32)
    gf = g.to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * r
    gscale = (gf * xhat).reshape(-1, x.shape[-1]).sum(0)
    gy = gf * scale.to(torch.float32)
    gx = r * (gy - xhat * torch.mean(gy * xhat, dim=-1, keepdim=True))
    return gx.to(x.dtype), gscale.to(scale.dtype)


# -- attention ---------------------------------------------------------------
def _visible(S: int, T: int, causal: bool, window: int,
             kv_len: Optional[int], device) -> torch.Tensor:
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos < (T if kv_len is None else kv_len)
    if causal:
        m = m & (kpos <= qpos)
    if window:
        m = m & (kpos > qpos - window)
    return m


def _attn_probs(q, k, causal, window, kv_len, scale):
    """fp32 (B, Hq, S, T) probabilities and visibility; q: (B,Hq,S,hd),
    k: (B,Hq,T,hd) already repeated to Hq heads. Masked entries get
    p = 0 exactly, so a row that sees no key has all-zero probabilities
    (and a zero output), as in the CUDA kernel."""
    S, T = q.shape[2], k.shape[2]
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    vis = _visible(S, T, causal, window, kv_len, q.device)
    logits = torch.where(vis, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * vis
    l = p.sum(dim=-1, keepdim=True)
    return p / torch.clamp(l, min=1e-30)


def _repeat_heads(x: torch.Tensor, hq: int) -> torch.Tensor:
    rep = hq // x.shape[1]
    return x.repeat_interleave(rep, dim=1) if rep > 1 else x


def sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True, window: int = 0,
             kv_len: Optional[int] = None,
             scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Hq,S,hd); k,v: (B,Hkv,T,hd) -> (B,Hq,S,hd) in q's dtype.
    fp32 logits, softmax and p.v, as the flash kernel computes them."""
    Hq, hd = q.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    qf = q.to(torch.float32)
    kf = _repeat_heads(k.to(torch.float32), Hq)
    vf = _repeat_heads(v.to(torch.float32), Hq)
    p = _attn_probs(qf, kf, causal, window, kv_len, scale)
    return torch.matmul(p, vf).to(q.dtype)


def sdpa_bwd_ref(q, k, v, g, *, causal: bool = True, window: int = 0,
                 kv_len: Optional[int] = None, scale: Optional[float] = None):
    """Gradients of ``sdpa_ref`` wrt (q, k, v), recomputed from the inputs
    in fp32 (BHSD layout; GQA gradients summed over each kv head's group):
    dV = P^T dO, dS = P (dO V^T - rowsum(dO O)), dQ = s dS K,
    dK = s dS^T Q."""
    B, Hq, S, hd = q.shape
    Hkv = k.shape[1]
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    qf = q.to(torch.float32)
    kf = _repeat_heads(k.to(torch.float32), Hq)
    vf = _repeat_heads(v.to(torch.float32), Hq)
    gf = g.to(torch.float32)
    p = _attn_probs(qf, kf, causal, window, kv_len, scale)
    o = torch.matmul(p, vf)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (gf * o).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    if Hkv != Hq:
        T = k.shape[2]
        dk = dk.reshape(B, Hkv, Hq // Hkv, T, hd).sum(2)
        dv = dv.reshape(B, Hkv, Hq // Hkv, T, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
