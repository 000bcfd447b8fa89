"""Block-level composition (``repro.models.blocks``): one residual block per
kind, pre-RMSNorm.

Kinds:
  enc        bidirectional attention + MLP (the ViT's block, and the
             encoder-decoder's encoder)
  dense      GQA attention (causal, optionally sliding-window) + MLP, the
             dense decoders' block (internlm2, starcoder2, mistral-large,
             internvl2's decoder, llama4's dense blocks)
  moe        GQA attention + the MoE FFN (llama4's MoE blocks)
  mla_moe    latent attention (MLA) + the MoE FFN (deepseek-v2)
  mamba      Mamba2 on the residual stream (zamba2's blocks)
  attn_only  the dense block under another name, Zamba2's shared block
  mlstm      an mLSTM on the residual stream (xlstm-125m)
  slstm      an sLSTM on the residual stream (xlstm-125m)
  cross      the encoder-decoder's decoder block: causal self-attention
             with RoPE, cross-attention to the encoder memory (no RoPE),
             MLP, each after an RMSNorm (seamless-m4t)

``block_apply`` returns (x, aux) as the reference does: aux is the MoE
kinds' weighted load-balance loss (an fp32 0-d tensor), and 0.0 for the
other kinds, which have none (a Python float, so that no kernel is spent
on a zero).

Block parameters are flat dicts keyed by their path inside the block
(``"ln1/scale"``, ``"attn/wq"``, ``"mamba/w_in"``, ``"moe/shared/w_up"``);
a stacked block tree has the same keys with leading stack axes, ``(L,
...)`` for the ViT, a uniform decoder and the encoder-decoder's two
stacks, ``(groups, attn_every, ...)`` for zamba2, ``(groups, slstm_every -
1, ...)`` for the xLSTM's mLSTM blocks and ``(groups, moe_every - 1,
...)`` for llama4's dense blocks, and ``(groups, ...)`` for the xLSTM's
sLSTM blocks and llama4's MoE blocks. The port indexes a layer's row
directly where the reference slices the stack.

Serving: ``block_cache_init`` is one layer's decode cache of a kind (the
Mamba2 or xLSTM state, MLA's latent cache, else the KV ring buffer, which
``cross`` keeps for its self-attention only: its cross attention is
recomputed from the memory at every step, as in the reference), and
``block_decode`` one token through one block. The MoE kinds decode
through ``moe_ffn``'s S = 1 branch (every expert densely).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.convert import subtree
from repro_torch.federated.leaves import tree_sorted
from repro_torch.models.layers import attention, mamba2, mla, moe, xlstm
from repro_torch.models.layers.attention import attn_apply, cross_attn_apply
from repro_torch.models.layers.init import dense_init_
from repro_torch.models.layers.mlp import mlp_apply, mlp_shapes
from repro_torch.models.layers.norms import rmsnorm

KINDS = ("enc", "dense", "moe", "mla_moe", "mamba", "attn_only", "mlstm",
         "slstm", "cross")
# the kinds whose block is one layer on the residual stream after an
# RMSNorm ("ln/scale"): (its subtree's shapes, its apply)
_RESIDUAL = {"mamba": (mamba2.mamba2_shapes, mamba2.mamba2_apply),
             "mlstm": (xlstm.mlstm_shapes, xlstm.mlstm_apply),
             "slstm": (xlstm.slstm_shapes, xlstm.slstm_apply)}
# the decoders of the residual kinds: (their state's init, their step)
_RESIDUAL_DECODE = {
    "mamba": (mamba2.init_state, mamba2.mamba2_decode),
    "mlstm": (xlstm.mlstm_init_state, xlstm.mlstm_decode),
    "slstm": (xlstm.slstm_init_state, xlstm.slstm_decode)}
# constant initial values, by kind and leaf path inside the kind's subtree
_CONSTANT_INIT = {"mamba": mamba2.CONSTANT_INIT,
                  "mlstm": xlstm.MLSTM_CONSTANT_INIT,
                  "slstm": xlstm.SLSTM_CONSTANT_INIT}
# weights drawn at another scale than the fan-in one, by the same keys
_INIT_SCALE = {"moe": moe.INIT_SCALE,
               "slstm": {xlstm.SLSTM_RECURRENT: 0.5}}
MOE_KINDS = ("moe", "mla_moe")


def _unknown(kind: str) -> ValueError:
    return ValueError(f"unknown block kind '{kind}' (one of "
                      f"{', '.join(KINDS)})")


def _attn_shapes(cfg, prefix: str) -> Dict[str, tuple]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {f"{prefix}/wk": (d, cfg.num_kv_heads * hd),
            f"{prefix}/wo": (cfg.num_heads * hd, d),
            f"{prefix}/wq": (d, cfg.num_heads * hd),
            f"{prefix}/wv": (d, cfg.num_kv_heads * hd)}


def block_shapes(cfg, kind: str = "enc") -> Dict[str, tuple]:
    """Per-layer parameter shapes of one block of ``kind``."""
    d = cfg.d_model
    if kind in _RESIDUAL:
        return {"ln/scale": (d,),
                **{f"{kind}/{k}": s
                   for k, s in _RESIDUAL[kind][0](cfg).items()}}
    if kind not in KINDS:
        raise _unknown(kind)
    shapes = {"ln1/scale": (d,), "ln2/scale": (d,)}
    if kind == "mla_moe":
        shapes.update({f"attn/{k}": s for k, s in mla.mla_shapes(cfg).items()})
    else:
        shapes.update(_attn_shapes(cfg, "attn"))
    if kind in MOE_KINDS:
        shapes.update({f"moe/{k}": s for k, s in moe.moe_shapes(cfg).items()})
    else:
        shapes.update({f"mlp/{k}": s for k, s in mlp_shapes(
            d, cfg.d_ff, cfg.act).items()})
    if kind == "cross":
        shapes.update({**_attn_shapes(cfg, "xattn"), "ln_x/scale": (d,)})
    return tree_sorted(shapes)


def stacked_init_(stacked: Dict[str, torch.Tensor], generator=None,
                  lead: int = 1) -> None:
    """In place, for block leaves with ``lead`` leading stack axes: norm
    scales to one, the Mamba2 and xLSTM leaves with constant initial values
    to those values, weights to fan-in truncated normal, as
    ``repro.models.layers.init.dense_init`` draws them: the fan-in is the
    per-layer leaf's first dim, and dim 1 of a 3-d one (the experts' (E,
    d, f), MLA's per-head (H, rank, n), the sLSTM's (H, P, 4P)); the MoE
    router at a tenth of the scale, the sLSTM's recurrent weights at
    half."""
    with torch.no_grad():
        for path, t in stacked.items():
            kind, _, name = path.partition("/")
            const = _CONSTANT_INIT.get(kind, {})
            if path.endswith("scale"):
                t.fill_(1.0)
            elif name in const:
                t.fill_(const[name])
            else:
                fan_in = t.shape[lead + 1] if t.dim() - lead == 3 \
                    else t.shape[lead]
                dense_init_(t, fan_in, generator,
                            scale=_INIT_SCALE.get(kind, {}).get(name, 1.0))


def block_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
                kind: str = "enc", memory: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """One residual block of ``kind`` over the full sequence. x: (B, S, d).
    ``enc`` attends bidirectionally; ``dense``, ``attn_only``, ``moe``,
    ``mla_moe`` and ``cross``'s self-attention with ``cfg.causal`` and
    ``cfg.window``; ``cross`` also attends to ``memory`` (B, T, d), the
    encoder's output. Returns (x, aux): the MoE kinds' load-balance loss,
    0.0 for the others."""
    if kind in _RESIDUAL:
        return x + _RESIDUAL[kind][1](
            subtree(p, kind), rmsnorm(x, p["ln/scale"], cfg.norm_eps),
            cfg), 0.0
    if kind not in KINDS:
        raise _unknown(kind)
    if kind == "enc":
        cfg = dataclasses.replace(cfg, causal=False)
    h = rmsnorm(x, p["ln1/scale"], cfg.norm_eps)
    attend = mla.mla_apply if kind == "mla_moe" else attn_apply
    x = x + attend(subtree(p, "attn"), h, cfg)
    if kind == "cross":
        h = rmsnorm(x, p["ln_x/scale"], cfg.norm_eps)
        x = x + cross_attn_apply(subtree(p, "xattn"), h, memory, cfg)
    h = rmsnorm(x, p["ln2/scale"], cfg.norm_eps)
    if kind in MOE_KINDS:
        y, aux = moe.moe_ffn(subtree(p, "moe"), h, cfg)
        return x + y, aux
    return x + mlp_apply(subtree(p, "mlp"), h, cfg.act,
                         getattr(torch, cfg.compute_dtype)), 0.0


def _check_decodes(kind: str) -> None:
    if kind not in KINDS:
        raise _unknown(kind)
    if kind == "enc":
        raise ValueError("the 'enc' kind (bidirectional) does not decode")


def block_cache_init(cfg, kind: str, batch: int, seq_len: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    """One layer's decode cache of ``kind``, for ``batch`` sequences of up
    to ``seq_len`` positions; attention caches in ``dtype``, recurrent
    states in fp32."""
    if kind in _RESIDUAL_DECODE:
        return _RESIDUAL_DECODE[kind][0](cfg, batch, device)
    _check_decodes(kind)
    if kind == "mla_moe":
        return mla.init_cache(cfg, batch, seq_len, dtype, device)
    return attention.init_cache(cfg, batch, seq_len, dtype, device)


def block_decode(p: Dict[str, torch.Tensor], x: torch.Tensor, cache, pos: int,
                 cfg, kind: str, memory: Optional[torch.Tensor] = None):
    """One token through one block of ``kind``. x: (B, 1, d) at position
    ``pos`` (a Python int); ``memory`` the encoder's output for ``cross``.
    Returns (x, the layer's new cache): attention caches are written in
    place and returned, recurrent states are new tensors."""
    if kind in _RESIDUAL_DECODE:
        y, st = _RESIDUAL_DECODE[kind][1](
            subtree(p, kind), rmsnorm(x, p["ln/scale"], cfg.norm_eps),
            cache, cfg)
        return x + y, st
    _check_decodes(kind)
    h = rmsnorm(x, p["ln1/scale"], cfg.norm_eps)
    decode = mla.mla_decode if kind == "mla_moe" else attention.attn_decode
    y, cache = decode(subtree(p, "attn"), h, cache, pos, cfg)
    x = x + y
    if kind == "cross":
        h = rmsnorm(x, p["ln_x/scale"], cfg.norm_eps)
        x = x + cross_attn_apply(subtree(p, "xattn"), h, memory, cfg)
    h = rmsnorm(x, p["ln2/scale"], cfg.norm_eps)
    if kind in MOE_KINDS:
        return x + moe.moe_ffn(subtree(p, "moe"), h, cfg)[0], cache
    return x + mlp_apply(subtree(p, "mlp"), h, cfg.act,
                         getattr(torch, cfg.compute_dtype)), cache
