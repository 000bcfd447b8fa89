"""Encoder-decoder transformer backbone (SeamlessM4T-medium style;
``repro.models.encdec``), the training path.

The speech frontend is the reference's stub: the encoder takes precomputed
frame embeddings (B, T, d). The encoder is a stack of ``enc`` blocks
(bidirectional attention with RoPE), the decoder a stack of ``cross``
blocks (causal self-attention, cross-attention to the encoder memory) over
the token embeddings.

Parameters are a flat ``{path: tensor}`` dict at the reference's key
paths, in ``jax.tree_util`` order: ``dec_blocks/...`` (dec_layers, ...),
``embed`` (V, d), ``enc_blocks/...`` (num_layers, ...), ``enc_ln/scale``,
``final_ln/scale`` and ``lm_head`` (d, V), which the reference creates
whether or not the embeddings are tied.

The encoder takes the layer-wise stage interface (``sub_layers``,
``active_from``: its frozen prefix runs under ``torch.no_grad()``); the
decoder always runs every block, as in the reference. ``remat`` recomputes
each block in the backward.

Serving: ``init_dec_caches`` is the decoder's self-attention KV caches
(dec_layers, ...) at the reference's paths (``k``, ``v``, ``pos``);
``decode_step`` runs one token through the decoder against a fixed
encoder memory (its cross attention recomputed from the memory every
step, as in the reference), under ``torch.no_grad()`` with the caches
written in place; ``prefill`` encodes the frames and runs the decoder over
the prompt.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.convert import subtree
from repro_torch.federated.leaves import tree_sorted
from repro_torch.models import blocks as B
from repro_torch.models import lm as lm_mod
from repro_torch.models.layers.init import embed_init_
from repro_torch.models.layers.norms import rmsnorm

Tree = lm_mod.Tree


def dec_layers(cfg) -> int:
    return cfg.dec_layers or cfg.num_layers


def encdec_shapes(cfg):
    d, V = cfg.d_model, cfg.vocab_size
    shapes = {"embed": (V, d), "enc_ln/scale": (d,), "final_ln/scale": (d,),
              "lm_head": (d, V)}
    shapes.update({f"enc_blocks/{k}": (cfg.num_layers,) + s
                   for k, s in B.block_shapes(cfg, "enc").items()})
    shapes.update({f"dec_blocks/{k}": (dec_layers(cfg),) + s
                   for k, s in B.block_shapes(cfg, "cross").items()})
    return tree_sorted(shapes)


def init_encdec(cfg, generator=None, device="cpu") -> Tree:
    """Freshly initialised parameters (``repro.models.encdec.init_encdec``'s
    initialisers; the draws come from ``generator``)."""
    dt = getattr(torch, cfg.param_dtype)
    params = {k: torch.empty(s, dtype=dt, device=device)
              for k, s in encdec_shapes(cfg).items()}
    for stack in ("enc_blocks", "dec_blocks"):
        B.stacked_init_(subtree(params, stack), generator, lead=1)
    with torch.no_grad():
        params["enc_ln/scale"].fill_(1.0)
        params["final_ln/scale"].fill_(1.0)
        for k in ("embed", "lm_head"):
            embed_init_(params[k], generator)
    return params


def encode(params: Tree, frames: torch.Tensor, cfg, *,
           sub_layers: Optional[int] = None, active_from: int = 0,
           remat: bool = False) -> torch.Tensor:
    """frames: (B, T, d) precomputed frontend embeddings -> the encoder
    memory (B, T, d) after the first ``sub_layers`` blocks, those below
    ``active_from`` frozen."""
    x = frames
    sub = cfg.num_layers if sub_layers is None else sub_layers
    act = max(0, min(active_from, sub))
    stack = subtree(params, "enc_blocks")

    def block(x, i):
        return lm_mod.remat_block({k: t[i] for k, t in stack.items()}, x,
                                  cfg, "enc", remat)[0]

    if act > 0:
        with torch.no_grad():
            for i in range(act):
                x = block(x, i)
    for i in range(act, sub):
        x = block(x, i)
    return rmsnorm(x, params["enc_ln/scale"], cfg.norm_eps)


def decode_train(params: Tree, tokens: torch.Tensor, memory: torch.Tensor,
                 cfg, *, remat: bool = False) -> torch.Tensor:
    """tokens (B, S) through every decoder block against ``memory`` ->
    the final-normed hidden states (B, S, d)."""
    x = lm_mod.embed(params, tokens, cfg)
    stack = subtree(params, "dec_blocks")
    for i in range(dec_layers(cfg)):
        x = lm_mod.remat_block({k: t[i] for k, t in stack.items()}, x,
                               cfg, "cross", remat, memory)[0]
    return rmsnorm(x, params["final_ln/scale"], cfg.norm_eps)


def encdec_loss(params: Tree, batch, cfg, *, sub_layers=None,
                active_from: int = 0, remat: bool = False):
    """batch: {"frontend": (B, T, d), "tokens": (B, S), "labels": (B, S),
    optional "mask"}. Returns (next-token loss, {"xent", "aux"})."""
    memory = encode(params, batch["frontend"], cfg, sub_layers=sub_layers,
                    active_from=active_from, remat=remat)
    hidden = decode_train(params, batch["tokens"], memory, cfg, remat=remat)
    loss = lm_mod.xent_loss(params, hidden, batch["labels"], cfg,
                            batch.get("mask"))
    return loss, {"xent": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=loss.device)}


def init_dec_caches(cfg, batch: int, seq_len: int, dtype=None,
                    device="cpu") -> Tree:
    """The decoder blocks' KV caches, attention caches in ``dtype``
    (default the compute dtype)."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    one = B.block_cache_init(cfg, "cross", batch, seq_len, dtype, device)
    return lm_mod._fix_pos(tree_sorted({
        k: torch.zeros((dec_layers(cfg),) + t.shape, dtype=t.dtype,
                       device=t.device) for k, t in one.items()}))


@torch.no_grad()
def decode_step(params: Tree, caches: Tree, token: torch.Tensor, pos: int,
                memory: torch.Tensor, cfg):
    """One decoder token (B, 1) at position ``pos`` (a Python int) against
    ``memory`` (B, T, d). Returns (logits (B, 1, V) fp32, caches)."""
    x = lm_mod.embed(params, token, cfg)
    stack = subtree(params, "dec_blocks")
    for i in range(dec_layers(cfg)):
        x = lm_mod.decode_block({k: t[i] for k, t in stack.items()}, x,
                                {k: t[i] for k, t in caches.items()}, pos,
                                cfg, "cross", memory)
    x = rmsnorm(x, params["final_ln/scale"], cfg.norm_eps)
    cdt = getattr(torch, cfg.compute_dtype)
    logits = x.to(cdt) @ params["lm_head"].to(cdt)
    return logits.to(torch.float32), caches


@torch.no_grad()
def prefill(params: Tree, frames: torch.Tensor, tokens: torch.Tensor, cfg):
    """Returns (the prompt's last logits (B, 1, V) fp32, the encoder
    memory)."""
    memory = encode(params, frames, cfg)
    hidden = decode_train(params, tokens, memory, cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    logits = hidden[:, -1:].to(cdt) @ params["lm_head"].to(cdt)
    return logits.to(torch.float32), memory
