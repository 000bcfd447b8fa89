"""Block-level composition (the ``enc`` kind of ``repro.models.blocks``:
bidirectional attention + MLP on the residual stream, pre-RMSNorm), plus
the stacked-parameter init ``repro.models.vit`` takes from
``repro.models.lm`` (``_stacked_init``; the port indexes a layer's row
directly where the reference slices the stack).

Block parameters are flat dicts keyed by their path inside the block
(``"ln1/scale"``, ``"attn/wq"``, ``"mlp/w_up"``); a stacked block tree has
the same keys with a leading layer axis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.convert import subtree
from repro_torch.models.layers.attention import attn_apply
from repro_torch.models.layers.init import dense_init_
from repro_torch.models.layers.mlp import mlp_apply
from repro_torch.models.layers.norms import rmsnorm


def block_shapes(cfg) -> Dict[str, tuple]:
    """Per-layer parameter shapes of one ``enc`` block."""
    if cfg.act != "gelu":
        raise NotImplementedError(
            f"activation '{cfg.act}' is not ported yet (the ViT block's "
            f"GELU MLP is; SwiGLU comes with the LM slice)")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "attn/wk": (d, cfg.num_kv_heads * hd),
        "attn/wo": (cfg.num_heads * hd, d),
        "attn/wq": (d, cfg.num_heads * hd),
        "attn/wv": (d, cfg.num_kv_heads * hd),
        "ln1/scale": (d,),
        "ln2/scale": (d,),
        "mlp/w_down": (cfg.d_ff, d),
        "mlp/w_up": (d, cfg.d_ff),
    }


def stacked_init_(stacked: Dict[str, torch.Tensor], generator=None) -> None:
    """In place: norm scales to one, weights to fan-in truncated normal
    (fan-in = the per-layer input dim)."""
    with torch.no_grad():
        for path, t in stacked.items():
            if path.endswith("scale"):
                t.fill_(1.0)
            else:
                dense_init_(t, t.shape[1], generator)


def block_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg) -> torch.Tensor:
    """One bidirectional residual block over the full sequence.
    x: (B, S, d)."""
    cfg = dataclasses.replace(cfg, causal=False)
    h = rmsnorm(x, p["ln1/scale"], cfg.norm_eps)
    x = x + attn_apply(subtree(p, "attn"), h, cfg)
    h = rmsnorm(x, p["ln2/scale"], cfg.norm_eps)
    return x + mlp_apply(subtree(p, "mlp"), h,
                         getattr(torch, cfg.compute_dtype))
