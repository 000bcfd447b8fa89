"""Full-sequence grouped-query attention with RoPE (the train / prefill
path of ``repro.models.layers.attention.attn_apply``).

The scaled dot product goes through the flash-attention kernel
(``kernels.ops.flash_attention``: the CUDA kernel on the card, its plain
version on the CPU), which maps each q head to its kv head itself, so K
and V are not repeated. The kernel keeps the probabilities in fp32 for
p.v; the JAX model's ``sdpa_dense`` casts them to the compute dtype first
(``sdpa.py:42-43``), so at bfloat16 the two differ by that rounding, and
at float32 they agree. The KV cache, decode and cross attention come with
the LM slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers.rope import apply_rope


def attn_apply(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """p: {"wq", "wk", "wv", "wo"}; x: (B, S, d) -> (B, S, d), with RoPE
    over positions 0..S-1."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    cdt = getattr(torch, cfg.compute_dtype)
    xc = x.to(cdt)
    q = (xc @ p["wq"].to(cdt)).reshape(B, S, cfg.num_heads, hd)
    k = (xc @ p["wk"].to(cdt)).reshape(B, S, cfg.num_kv_heads, hd)
    v = (xc @ p["wv"].to(cdt)).reshape(B, S, cfg.num_kv_heads, hd)
    positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=cfg.causal, window=cfg.window)
    y = out.reshape(B, S, cfg.num_heads * hd) @ p["wo"].to(cdt)
    return y.to(x.dtype)
