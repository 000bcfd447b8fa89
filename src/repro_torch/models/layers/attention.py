"""Full-sequence grouped-query attention with RoPE (the train / prefill
path of ``repro.models.layers.attention.attn_apply``), and the
encoder-decoder's cross attention (``cross_attn_apply``): queries from the
decoder's stream, keys and values from the encoder memory, no RoPE, no
mask, S queries over T keys.

The scaled dot product goes through the flash-attention kernel
(``kernels.ops.flash_attention``: the CUDA kernel on the card, its plain
version on the CPU), which maps each q head to its kv head itself, so K
and V are not repeated. The plain version keeps the q.k logits and the
probabilities in fp32; the JAX model's ``sdpa_dense`` rounds both to the
compute dtype (``sdpa.py:38-43``), and the bf16 CUDA kernel rounds the
probabilities (not the logits) to bf16 for its tensor-core p.v. At
float32 all agree. At bfloat16 on a 2-block ViT
(``tests/test_torch_model.py``, on the CPU) the encoder outputs differ by
1.23 bf16 roundings of their largest value and the SSL loss by 1.5%;
rounding like ``sdpa_dense`` moves these to 1.07 and 1.6%, so the gap is
the other bf16 roundings (the matmuls, amplified by the heads'
BatchNorm), not this one. The KV cache and decode (serving) are not
ported yet.
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


def cross_attn_apply(p, x: torch.Tensor, memory: torch.Tensor,
                     cfg) -> torch.Tensor:
    """p: {"wq", "wk", "wv", "wo"}; x: (B, S, d) queries; memory: (B, T, d)
    the encoder's output -> (B, S, d). Non-causal, without RoPE."""
    B, S, _ = x.shape
    T = memory.shape[1]
    hd = cfg.resolved_head_dim
    cdt = getattr(torch, cfg.compute_dtype)
    xc, mc = x.to(cdt), memory.to(cdt)
    q = (xc @ p["wq"].to(cdt)).reshape(B, S, cfg.num_heads, hd)
    k = (mc @ p["wk"].to(cdt)).reshape(B, T, cfg.num_kv_heads, hd)
    v = (mc @ p["wv"].to(cdt)).reshape(B, T, cfg.num_kv_heads, hd)
    out = ops.flash_attention(q, k, v, causal=False)
    y = out.reshape(B, S, cfg.num_heads * hd) @ p["wo"].to(cdt)
    return y.to(x.dtype)
