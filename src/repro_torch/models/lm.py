"""Decoder-only language model assembly (``repro.models.lm``), for the
``zamba`` topology: groups of ``attn_every`` Mamba2 blocks, each group
followed by one *shared* attention + MLP block (Zamba2, arXiv:2411.15242);
the shared block's weights are reused after every group.

Parameters are a flat ``{path: tensor}`` dict at the JAX key paths, in
``jax.tree_util`` order: ``embed`` (V, d), ``final_ln/scale``, ``lm_head``
(d, V), the Mamba2 stack ``blocks/...`` with leaves (groups, attn_every,
...), and ``shared_attn/...``. A layer-wise stage is one group.

The stage interface is the JAX package's: ``sub_layers`` limits the depth
(in stages), and the groups below ``active_from`` run under
``torch.no_grad()`` where the reference applies ``stop_gradient``, so
neither they, nor the embedding, nor the shared block's uses there get
gradients. The other topologies (uniform, xlstm, moe_il), the frontend
stubs, caches, prefill and decode are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.convert import subtree
from repro_torch.federated.leaves import tree_sorted
from repro_torch.models import blocks as B
from repro_torch.models.layers.init import embed_init_
from repro_torch.models.layers.norms import rmsnorm

LOSS_CHUNK = 512
Tree = Dict[str, torch.Tensor]


def topology(cfg) -> str:
    if cfg.family == "hybrid":
        return "zamba"
    if cfg.xlstm is not None:
        return "xlstm"
    if cfg.moe is not None and cfg.moe.num_experts > 0 \
            and cfg.moe.moe_every > 1 and cfg.mla is None:
        return "moe_il"
    return "uniform"


def _zamba(cfg) -> None:
    topo = topology(cfg)
    if topo != "zamba":
        raise NotImplementedError(
            f"LM topology '{topo}' ({cfg.arch_id}) is not ported to "
            f"repro_torch yet (ported: zamba)")


def num_stages(cfg) -> int:
    """Stage granularity of the layer-wise schedule: one group of
    ``attn_every`` Mamba2 blocks."""
    _zamba(cfg)
    return cfg.num_layers // cfg.attn_every


def lm_shapes(cfg) -> Dict[str, tuple]:
    _zamba(cfg)
    g = num_stages(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    shapes = {"embed": (V, d), "final_ln/scale": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, V)
    shapes.update({f"blocks/{k}": (g, cfg.attn_every) + s
                   for k, s in B.block_shapes(cfg, "mamba").items()})
    shapes.update({f"shared_attn/{k}": s
                   for k, s in B.block_shapes(cfg, "attn_only").items()})
    return tree_sorted(shapes)


def init_lm(cfg, generator=None, device="cpu") -> Tree:
    """Freshly initialised parameters (``repro.models.lm.init_lm``'s
    initialisers; the draws come from ``generator``)."""
    dt = getattr(torch, cfg.param_dtype)
    params = {k: torch.empty(s, dtype=dt, device=device)
              for k, s in lm_shapes(cfg).items()}
    B.stacked_init_(subtree(params, "blocks"), generator, lead=2)
    B.stacked_init_(subtree(params, "shared_attn"), generator, lead=0)
    with torch.no_grad():
        params["final_ln/scale"].fill_(1.0)
        for k in ("embed", "lm_head"):
            if k in params:
                embed_init_(params[k], generator)
    return params


def embed(params: Tree, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens (B, S) -> (B, S, d) in the parameter dtype, times sqrt(d)."""
    x = params["embed"][tokens]
    return x * math.sqrt(cfg.d_model)


def _head_matrix(params: Tree, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def forward_hidden(params: Tree, x: torch.Tensor, cfg, *,
                   sub_layers: Optional[int] = None, active_from: int = 0):
    """x: (B, S, d) embedded inputs. Returns (hidden, aux_loss); the aux
    loss of these block kinds is 0."""
    S = num_stages(cfg)
    sub = S if sub_layers is None else sub_layers
    act = max(0, min(active_from, sub))
    stack = subtree(params, "blocks")
    shared = subtree(params, "shared_attn")

    def group(x, gi):
        for i in range(cfg.attn_every):
            x = B.block_apply({k: t[gi, i] for k, t in stack.items()}, x,
                              cfg, "mamba")
        return B.block_apply(shared, x, cfg, "attn_only")

    if act > 0:
        with torch.no_grad():
            for gi in range(act):
                x = group(x, gi)
    for gi in range(act, sub):
        x = group(x, gi)
    x = rmsnorm(x, params["final_ln/scale"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def xent_loss(params: Tree, hidden: torch.Tensor, labels: torch.Tensor,
              cfg, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy. hidden: (B, S, d); labels: (B, S);
    mask: (B, S) {0, 1}. Chunked over the sequence by ``LOSS_CHUNK`` (the
    whole sequence when it does not divide S), so the (B, S, V) logits are
    never whole; the gold logit is taken by index."""
    Bsz, S, _ = hidden.shape
    W = _head_matrix(params, cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    if mask is None:
        mask = torch.ones((Bsz, S), dtype=torch.float32, device=hidden.device)
    c = LOSS_CHUNK if S % LOSS_CHUNK == 0 else S
    Wc = W.to(cdt)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, c):
        hc, yc, mc = hidden[:, s0:s0 + c], labels[:, s0:s0 + c], \
            mask[:, s0:s0 + c]
        logits = (hc.to(cdt) @ Wc).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, yc[..., None].long(),
                                    dim=-1)[..., 0]
        tot = tot + torch.sum((logz - gold) * mc)
        cnt = cnt + torch.sum(mc)
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params: Tree, batch, cfg, *, sub_layers=None,
            active_from: int = 0):
    """batch: {"tokens": (B, S), "labels": (B, S), optional "mask"}.
    Returns (loss, {"xent", "aux"})."""
    x = embed(params, batch["tokens"], cfg)
    hidden, aux = forward_hidden(params, x, cfg, sub_layers=sub_layers,
                                 active_from=active_from)
    loss = xent_loss(params, hidden, batch["labels"], cfg, batch.get("mask"))
    return loss + aux, {"xent": loss, "aux": aux}
