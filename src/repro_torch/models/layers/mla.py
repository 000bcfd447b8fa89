"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), the train /
prefill path of ``repro.models.layers.mla``.

Keys and values come from a rank-``kv_lora_rank`` latent ``c_kv = x w_dkv``
expanded per head (``w_uk``, ``w_uv``), plus one RoPE key shared by every
head (``w_kr``); queries are ``x w_q``, or ``(x w_dq) w_uq`` with a
``q_lora_rank``, split per head into a no-RoPE part and a RoPE part. Each
head's q and k are (nope + rope) wide and its v ``v_head_dim``: the
flash-attention kernel takes the two head dims apart (192 / 128 at
deepseek-v2's published widths), with the scale 1/sqrt(nope + rope), as
the reference's ``sdpa_dense`` computes it. The latent cache and the
absorbed decode (``init_cache``, ``mla_decode``) belong to serving and are
not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers.rope import apply_rope


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
    positions = torch.arange(S, device=x.device)
    c_kv = xc @ p["w_dkv"].to(cdt)                             # (B, S, r)
    k_rope = apply_rope((xc @ p["w_kr"].to(cdt))[:, :, None, :], positions,
                        cfg.rope_theta)                        # (B,S,1,rd)
    q_nope, q_rope = _split_q(_q_proj(p, xc, cfg, cdt), cfg)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_nope = torch.einsum("bsr,hrn->bshn", c_kv, p["w_uk"].to(cdt))
    v = torch.einsum("bsr,hrv->bshv", c_kv, p["w_uv"].to(cdt))
    q = torch.cat([q_nope, q_rope], dim=-1)                    # (B,S,H,qd)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)],
                  dim=-1)
    out = ops.flash_attention(q, k, v.contiguous(), causal=cfg.causal,
                              window=cfg.window)               # (B,S,H,vd)
    y = out.reshape(B, S, H * m.v_head_dim) @ p["wo"].to(cdt)
    return y.to(x.dtype)
