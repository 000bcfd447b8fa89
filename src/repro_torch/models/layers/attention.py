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
BatchNorm), not this one.

Serving (``cache_size``, ``init_cache``, ``attn_decode``): one token a
step against a KV cache of W = min(seq_len, window) slots (all of
seq_len without a window), a ring buffer whose slot ``pos % W`` takes the
token at position ``pos``. Keys are stored after RoPE, so an evicted slot
needs no re-rotation; the ``pos`` leaf records each slot's position (-1
while empty), as the reference's does. The reference masks by those
positions (causal and window, empty slots at 2^30). The port needs no
positions in the kernel: the ring holds exactly the positions max(0, pos
- W + 1) .. pos, every one of them inside the window and none after the
query, in slots 0 .. min(pos + 1, W) - 1, so the kernel's ``kv_len`` mask
over the slots is the whole mask (``causal=False``: the kernel counts
query positions from 0, so a causal single query would see slot 0 only).
``kv_len`` comes from the Python ``pos``; nothing is read back from the
card within a step.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers.rope import apply_rope
from repro_torch.sharding.aten import (CACHE_READ, CACHE_WRITE,
                                       collective_source)

Cache = Dict[str, torch.Tensor]


def attn_apply(p, x: torch.Tensor, cfg,
               scale: Optional[float] = None) -> torch.Tensor:
    """p: {"wq", "wk", "wv", "wo"}; x: (B, S, d_in) -> (B, S, d), with
    RoPE over positions 0..S-1 (d_in is wq's rows: Zamba2's shared block
    attends over its 2 d wide joined input); q.k times ``scale``, 1 /
    sqrt(head_dim) by default."""
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
    out = ops.flash_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                              scale=scale)
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


# -- KV cache (a ring buffer with a sliding window) ---------------------------
def cache_size(cfg, seq_len: int) -> int:
    return min(seq_len, cfg.window) if cfg.window else seq_len


def init_cache(cfg, batch: int, seq_len: int, dtype,
               device=None) -> Cache:
    """One layer's cache: ``k``, ``v`` (B, W, Hkv, hd) zeros in ``dtype``
    and ``pos`` (W,) int32 at -1 (empty)."""
    W = cache_size(cfg, seq_len)
    shape = (batch, W, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((W,), -1, dtype=torch.int32, device=device)}


def attn_decode(p, x: torch.Tensor, cache: Cache, pos: int,
                cfg) -> Tuple[torch.Tensor, Cache]:
    """One token. p: {"wq", "wk", "wv", "wo"}; x: (B, 1, d) at position
    ``pos`` (a Python int). Writes the token's k, v and position into the
    cache's slot ``pos % W`` in place and returns (y (B, 1, d), cache)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    cdt = getattr(torch, cfg.compute_dtype)
    W = cache["k"].shape[1]
    xc = x.to(cdt)
    q = (xc @ p["wq"].to(cdt)).reshape(B, 1, cfg.num_heads, hd)
    k = (xc @ p["wk"].to(cdt)).reshape(B, 1, cfg.num_kv_heads, hd)
    v = (xc @ p["wv"].to(cdt)).reshape(B, 1, cfg.num_kv_heads, hd)
    positions = torch.full((1,), pos, dtype=torch.float32, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    slot = pos % W
    with collective_source(CACHE_WRITE):
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][slot] = pos
    with collective_source(CACHE_READ):
        out = ops.flash_attention(q, cache["k"].to(cdt), cache["v"].to(cdt),
                                  causal=False, window=0,
                                  kv_len=min(pos + 1, W))
    y = out.reshape(B, 1, cfg.num_heads * hd) @ p["wo"].to(cdt)
    return y.to(x.dtype), cache
