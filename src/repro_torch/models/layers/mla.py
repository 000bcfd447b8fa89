"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), the train /
prefill path of ``repro.models.layers.mla``.

Keys and values come from a rank-``kv_lora_rank`` latent ``c_kv = x w_dkv``
expanded per head (``w_uk``, ``w_uv``), plus one RoPE key shared by every
head (``w_kr``); queries are ``x w_q``, or ``(x w_dq) w_uq`` with a
``q_lora_rank``, split per head into a no-RoPE part and a RoPE part. Each
head's q and k are (nope + rope) wide and its v ``v_head_dim``: the
flash-attention kernel takes the two head dims apart (192 / 128 at
deepseek-v2's published widths), with the scale 1/sqrt(nope + rope), as
the reference's ``sdpa_dense`` computes it.

Serving: the cache holds only the latent ``c_kv`` and the shared RoPE key
``k_rope`` of each position (a ring buffer of W slots, as the GQA
cache, with its ``pos`` leaf), and ``mla_decode`` is the reference's
absorbed form: ``q_nope w_uk`` scores against ``c_kv`` directly and the
attended latent goes through ``w_uv`` afterwards, so no per-head key or
value is ever expanded. The reference computes these products and the
softmax outside any Pallas kernel (with its ``valid`` mask and
``NEG_INF``), so they are plain PyTorch here.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers.attention import cache_size
from repro_torch.models.layers.rope import apply_rope, seq_table
from repro_torch.sharding.aten import (CACHE_READ, CACHE_WRITE,
                                       collective_source)

NEG_INF = -1e30


def qk_head_dim(cfg) -> int:
    return cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim


def mla_shapes(cfg) -> Dict[str, tuple]:
    """Per-layer leaf shapes (``mla_init``): ``w_dq`` (d, q rank) and
    ``w_uq`` (q rank, H (nope + rope)) with a ``q_lora_rank``, else ``w_q``
    (d, H (nope + rope))."""
    m, d, H = cfg.mla, cfg.d_model, cfg.num_heads
    shapes = {"w_dkv": (d, m.kv_lora_rank), "w_kr": (d, m.qk_rope_head_dim),
              "w_uk": (H, m.kv_lora_rank, m.qk_nope_head_dim),
              "w_uv": (H, m.kv_lora_rank, m.v_head_dim),
              "wo": (H * m.v_head_dim, d)}
    if m.q_lora_rank:
        shapes.update({"w_dq": (d, m.q_lora_rank),
                       "w_uq": (m.q_lora_rank, H * qk_head_dim(cfg))})
    else:
        shapes["w_q"] = (d, H * qk_head_dim(cfg))
    return shapes


def _q_proj(p, xc: torch.Tensor, cfg, cdt) -> torch.Tensor:
    if cfg.mla.q_lora_rank:
        return (xc @ p["w_dq"].to(cdt)) @ p["w_uq"].to(cdt)
    return xc @ p["w_q"].to(cdt)


def _split_q(q: torch.Tensor, cfg):
    """(..., H (nope + rope)) -> the (..., H, nope) and (..., H, rope)
    parts."""
    q = q.reshape(*q.shape[:-1], cfg.num_heads, qk_head_dim(cfg))
    n = cfg.mla.qk_nope_head_dim
    return q[..., :n], q[..., n:]


def mla_apply(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """p: one layer's MLA leaves (``mla_shapes``); x: (B, S, d) -> (B, S,
    d), RoPE over positions 0..S-1, ``cfg.causal`` and ``cfg.window``."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    cdt = getattr(torch, cfg.compute_dtype)
    xc = x.to(cdt)
    table = seq_table(S, m.qk_rope_head_dim, cfg.rope_theta, x.device)
    c_kv = xc @ p["w_dkv"].to(cdt)                             # (B, S, r)
    k_rope = ops.rope((xc @ p["w_kr"].to(cdt))[:, :, None, :],
                      *table)                                  # (B,S,1,rd)
    q_nope, q_rope = _split_q(_q_proj(p, xc, cfg, cdt), cfg)
    q_rope = ops.rope(q_rope, *table)
    k_nope = torch.einsum("bsr,hrn->bshn", c_kv, p["w_uk"].to(cdt))
    v = torch.einsum("bsr,hrv->bshv", c_kv, p["w_uv"].to(cdt))
    q = torch.cat([q_nope, q_rope], dim=-1)                    # (B,S,H,qd)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)],
                  dim=-1)
    out = ops.flash_attention(q, k, v.contiguous(), causal=cfg.causal,
                              window=cfg.window)               # (B,S,H,vd)
    y = out.reshape(B, S, H * m.v_head_dim) @ p["wo"].to(cdt)
    return y.to(x.dtype)


def init_cache(cfg, batch: int, seq_len: int, dtype,
               device=None) -> Dict[str, torch.Tensor]:
    """One layer's latent cache: ``c_kv`` (B, W, kv rank), ``k_rope`` (B,
    W, rope dim) zeros in ``dtype`` and ``pos`` (W,) int32 at -1."""
    m, W = cfg.mla, cache_size(cfg, seq_len)
    return {"c_kv": torch.zeros((batch, W, m.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, W, m.qk_rope_head_dim),
                                  dtype=dtype, device=device),
            "pos": torch.full((W,), -1, dtype=torch.int32, device=device)}


def mla_decode(p, x: torch.Tensor, cache, pos: int,
               cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed single-token decode. x: (B, 1, d) at position ``pos`` (a
    Python int); writes slot ``pos % W`` of the cache in place and returns
    (y (B, 1, d), cache)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.num_heads
    cdt = getattr(torch, cfg.compute_dtype)
    W = cache["c_kv"].shape[1]
    xc = x.to(cdt)
    positions = torch.full((1,), pos, dtype=torch.float32, device=x.device)
    c_kv_new = xc @ p["w_dkv"].to(cdt)                         # (B, 1, r)
    k_rope_new = apply_rope((xc @ p["w_kr"].to(cdt))[:, :, None, :],
                            positions, cfg.rope_theta)[:, :, 0]
    q_nope, q_rope = _split_q(_q_proj(p, xc, cfg, cdt), cfg)   # (B,1,H,*)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    q_lat = torch.einsum("bshn,hrn->bshr", q_nope, p["w_uk"].to(cdt))
    slot = pos % W
    with collective_source(CACHE_WRITE):
        cache["c_kv"][:, slot] = c_kv_new[:, 0].to(cache["c_kv"].dtype)
        cache["k_rope"][:, slot] = k_rope_new[:, 0].to(
            cache["k_rope"].dtype)
        cache["pos"][slot] = pos
    with collective_source(CACHE_READ):
        c_kv, k_rope, cpos = cache["c_kv"].to(cdt), \
            cache["k_rope"].to(cdt), cache["pos"]
        logits = (torch.einsum("bshr,btr->bhst", q_lat, c_kv)
                  + torch.einsum("bshr,btr->bhst", q_rope, k_rope))
        logits = logits.to(torch.float32) * \
            (1.0 / math.sqrt(qk_head_dim(cfg)))
        valid = (cpos >= 0) & (cpos <= pos)
        if cfg.window:
            valid = valid & (cpos > pos - cfg.window)
        logits = torch.where(valid[None, None, None, :], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(cdt)
        out_lat = torch.einsum("bhst,btr->bshr", probs, c_kv)  # (B,1,H,r)
    out = torch.einsum("bshr,hrv->bshv", out_lat, p["w_uv"].to(cdt))
    y = out.reshape(B, 1, H * m.v_head_dim) @ p["wo"].to(cdt)
    return y.to(x.dtype), cache
