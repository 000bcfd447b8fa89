"""Block-level composition (``repro.models.blocks``): one residual block per
kind, pre-RMSNorm.

Kinds ported so far:
  enc        bidirectional attention + MLP (the ViT's block)
  dense      GQA attention (causal, optionally sliding-window) + MLP, the
             dense decoders' block (internlm2, starcoder2, mistral-large,
             internvl2's decoder)
  mamba      Mamba2 on the residual stream (zamba2's blocks)
  attn_only  the dense block under another name, Zamba2's shared block
The reference's moe, mla_moe, mlstm, slstm and cross kinds are not ported.

Block parameters are flat dicts keyed by their path inside the block
(``"ln1/scale"``, ``"attn/wq"``, ``"mamba/w_in"``); a stacked block tree
has the same keys with leading stack axes, ``(L, ...)`` for the ViT and
``(groups, attn_every, ...)`` for zamba2, ``(L, ...)`` for a dense
decoder. The port indexes a layer's row
directly where the reference slices the stack.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.convert import subtree
from repro_torch.models.layers import mamba2
from repro_torch.models.layers.attention import attn_apply
from repro_torch.models.layers.init import dense_init_
from repro_torch.models.layers.mlp import mlp_apply, mlp_shapes
from repro_torch.models.layers.norms import rmsnorm

KINDS = ("enc", "dense", "mamba", "attn_only")
_ATTN_MLP = ("enc", "dense", "attn_only")


def _unported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind '{kind}' is not ported to repro_torch yet (ported: "
        f"{', '.join(KINDS)})")


def block_shapes(cfg, kind: str = "enc") -> Dict[str, tuple]:
    """Per-layer parameter shapes of one block of ``kind``."""
    d = cfg.d_model
    if kind == "mamba":
        return {"ln/scale": (d,),
                **{f"mamba/{k}": s
                   for k, s in mamba2.mamba2_shapes(cfg).items()}}
    if kind not in _ATTN_MLP:
        raise _unported(kind)
    hd = cfg.resolved_head_dim
    return {
        "attn/wk": (d, cfg.num_kv_heads * hd),
        "attn/wo": (cfg.num_heads * hd, d),
        "attn/wq": (d, cfg.num_heads * hd),
        "attn/wv": (d, cfg.num_kv_heads * hd),
        "ln1/scale": (d,),
        "ln2/scale": (d,),
        **{f"mlp/{k}": s for k, s in mlp_shapes(d, cfg.d_ff,
                                                cfg.act).items()},
    }


def stacked_init_(stacked: Dict[str, torch.Tensor], generator=None,
                  lead: int = 1) -> None:
    """In place, for block leaves with ``lead`` leading stack axes: norm
    scales to one, the Mamba2 leaves with constant initial values to those
    values, weights to fan-in truncated normal (fan-in = the per-layer
    leaf's first dim, as ``repro.models.layers.init.dense_init`` takes)."""
    with torch.no_grad():
        for path, t in stacked.items():
            name = path[len("mamba/"):] if path.startswith("mamba/") else None
            if path.endswith("scale"):
                t.fill_(1.0)
            elif name in mamba2.CONSTANT_INIT:
                t.fill_(mamba2.CONSTANT_INIT[name])
            else:
                dense_init_(t, t.shape[lead], generator)


def block_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
                kind: str = "enc") -> torch.Tensor:
    """One residual block of ``kind`` over the full sequence. x: (B, S, d).
    ``enc`` attends bidirectionally; ``dense`` and ``attn_only`` with
    ``cfg.causal`` and ``cfg.window``."""
    if kind == "mamba":
        return x + mamba2.mamba2_apply(
            subtree(p, "mamba"), rmsnorm(x, p["ln/scale"], cfg.norm_eps),
            cfg)
    if kind not in _ATTN_MLP:
        raise _unported(kind)
    if kind == "enc":
        cfg = dataclasses.replace(cfg, causal=False)
    h = rmsnorm(x, p["ln1/scale"], cfg.norm_eps)
    x = x + attn_apply(subtree(p, "attn"), h, cfg)
    h = rmsnorm(x, p["ln2/scale"], cfg.norm_eps)
    return x + mlp_apply(subtree(p, "mlp"), h, cfg.act,
                         getattr(torch, cfg.compute_dtype))
