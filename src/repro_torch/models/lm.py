"""Decoder-only language model assembly (``repro.models.lm``), for four
topologies:

- ``uniform``: L identical blocks, ``dense`` (GQA attention + MLP:
  internlm2, starcoder2, mistral-large, internvl2's decoder) or
  ``mla_moe`` (latent attention + MoE FFN: deepseek-v2), or ``moe``; a
  layer-wise stage is one block.
- ``moe_il``: groups of ``moe_every - 1`` dense blocks followed by one MoE
  block (llama4's interleave); a stage is one group.
- ``zamba``: groups of ``attn_every`` Mamba2 blocks, each group followed by
  one *shared* attention + MLP block (Zamba2, arXiv:2411.15242); the shared
  block's weights are reused after every group; a stage is one group.
- ``xlstm``: groups of ``slstm_every - 1`` mLSTM blocks followed by one
  sLSTM block (xLSTM, arXiv:2405.04517); a stage is one group.

Parameters are a flat ``{path: tensor}`` dict at the JAX key paths, in
``jax.tree_util`` order: ``embed`` (V, d), ``final_ln/scale``, ``lm_head``
(d, V) unless the embeddings are tied, and the block stacks:
``blocks/...`` with leaves (L, ...) (uniform), (groups, moe_every - 1,
...) (moe_il, plus ``moe_blocks/...`` (groups, ...)) or (groups,
attn_every, ...) (zamba, plus ``shared_attn/...``), or ``mlstm/...``
(groups, slstm_every - 1, ...) and ``slstm/...`` (groups, ...) (xlstm).

The stage interface is the JAX package's: ``sub_layers`` limits the depth
(in stages), and the stages below ``active_from`` run under
``torch.no_grad()`` where the reference applies ``stop_gradient``, so
neither they, nor the embedding, nor (zamba) the shared block's uses there
get gradients, and their MoE load-balance loss enters the total without
one. ``remat`` recomputes each trained block in the backward (the
reference's per-block ``jax.checkpoint``; as there, not zamba's shared
block, the xLSTM's sLSTM blocks nor llama4's MoE blocks). The VLM frontend
is the reference's stub: precomputed (B, P, d) embeddings put ahead of the
token embeddings (``embed(..., frontend)``). A uniform stack of Mamba2
blocks (no config of the JAX package has one), caches, prefill and decode
(serving) are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch.func import vjp

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


def uniform_kind(cfg) -> str:
    if cfg.mla is not None:
        return "mla_moe"
    if cfg.moe is not None and cfg.moe.num_experts > 0:
        return "moe"
    if cfg.ssm is not None:
        return "mamba"
    return "dense"


def _ported(cfg) -> str:
    """The topology of ``cfg``; raises for a uniform Mamba2 stack, the one
    not ported."""
    topo = topology(cfg)
    if topo == "uniform" and uniform_kind(cfg) == "mamba":
        raise NotImplementedError(
            f"LM topology 'uniform with mamba blocks' ({cfg.arch_id}) is not "
            f"ported to repro_torch yet (ported: zamba, xlstm, moe_il, "
            f"uniform with dense, moe or mla_moe blocks)")
    return topo


def _xlstm_groups(cfg):
    """(groups, blocks a group) of the xlstm topology."""
    per = cfg.xlstm.slstm_every or cfg.num_layers
    return cfg.num_layers // per, per


def num_stages(cfg) -> int:
    """Stage granularity of the layer-wise schedule: one block (uniform),
    one group of ``attn_every`` Mamba2 blocks (zamba), of ``moe_every``
    blocks (moe_il) or of ``slstm_every`` xLSTM blocks (xlstm; one block a
    stage when ``slstm_every`` is 0, as the reference counts it)."""
    topo = _ported(cfg)
    if topo == "zamba":
        return cfg.num_layers // cfg.attn_every
    if topo == "moe_il":
        return cfg.num_layers // cfg.moe.moe_every
    if topo == "xlstm" and cfg.xlstm.slstm_every:
        return cfg.num_layers // cfg.xlstm.slstm_every
    return cfg.num_layers


def lm_shapes(cfg) -> Dict[str, tuple]:
    topo = _ported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    shapes = {"embed": (V, d), "final_ln/scale": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, V)
    if topo == "uniform":
        shapes.update({f"blocks/{k}": (cfg.num_layers,) + s for k, s in
                       B.block_shapes(cfg, uniform_kind(cfg)).items()})
        return tree_sorted(shapes)
    if topo == "moe_il":
        g, per = num_stages(cfg), cfg.moe.moe_every
        shapes.update({f"blocks/{k}": (g, per - 1) + s
                       for k, s in B.block_shapes(cfg, "dense").items()})
        shapes.update({f"moe_blocks/{k}": (g,) + s
                       for k, s in B.block_shapes(cfg, "moe").items()})
        return tree_sorted(shapes)
    if topo == "xlstm":
        g, per = _xlstm_groups(cfg)
        shapes.update({f"mlstm/{k}": (g, per - 1) + s
                       for k, s in B.block_shapes(cfg, "mlstm").items()})
        shapes.update({f"slstm/{k}": (g,) + s
                       for k, s in B.block_shapes(cfg, "slstm").items()})
        return tree_sorted(shapes)
    shapes.update({f"blocks/{k}": (num_stages(cfg), cfg.attn_every) + s
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
    topo = topology(cfg)
    if topo == "uniform":
        B.stacked_init_(subtree(params, "blocks"), generator, lead=1)
    elif topo == "moe_il":
        B.stacked_init_(subtree(params, "blocks"), generator, lead=2)
        B.stacked_init_(subtree(params, "moe_blocks"), generator, lead=1)
    elif topo == "xlstm":
        B.stacked_init_(subtree(params, "mlstm"), generator, lead=2)
        B.stacked_init_(subtree(params, "slstm"), generator, lead=1)
    else:
        B.stacked_init_(subtree(params, "blocks"), generator, lead=2)
        B.stacked_init_(subtree(params, "shared_attn"), generator, lead=0)
    with torch.no_grad():
        params["final_ln/scale"].fill_(1.0)
        for k in ("embed", "lm_head"):
            if k in params:
                embed_init_(params[k], generator)
    return params


def embed(params: Tree, tokens: torch.Tensor, cfg,
          frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) -> (B, S, d) in the parameter dtype, times sqrt(d);
    with ``frontend`` (B, P, d), (B, P + S, d), the frontend first."""
    x = params["embed"][tokens]
    x = x * math.sqrt(cfg.d_model)
    if frontend is not None:
        x = torch.cat([frontend.to(x.dtype), x], dim=1)
    return x


def _head_matrix(params: Tree, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


class _Remat(torch.autograd.Function):
    """Rematerialisation of one block: the forward keeps only its inputs,
    and the backward recomputes the block inside ``torch.func.vjp``. It
    works under autograd and under ``torch.func.grad`` / ``vmap`` alike;
    ``torch.utils.checkpoint`` does not, since the ``torch.func``
    transforms refuse its saved-tensor hooks. ``fn`` returns a tensor, or
    a tuple of tensors (a MoE block's output and load-balance loss)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, x, *weights):
        with torch.no_grad():
            return fn(x, *weights)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, *tensors = inputs
        ctx.fn = fn
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        _, pull = vjp(ctx.fn, *ctx.saved_tensors)
        return (None, *pull(grads if len(grads) > 1 else grads[0]))


def remat_block(p: Tree, x: torch.Tensor, cfg, kind: str, remat: bool,
                memory: Optional[torch.Tensor] = None):
    """One block of ``kind`` (``block_apply``: returns (x, aux)),
    recomputed in the backward when ``remat``; ``memory`` (the encoder's
    output, for ``cross``) is an input of the recomputed block, so that its
    gradient flows."""
    if not remat or not torch.is_grad_enabled():
        return B.block_apply(p, x, cfg, kind, memory=memory)
    keys, has_aux = list(p), kind in B.MOE_KINDS
    inputs = (x,) if memory is None else (x, memory)

    def fn(*args):
        mem = None if memory is None else args[1]
        y, aux = B.block_apply(dict(zip(keys, args[len(inputs):])), args[0],
                               cfg, kind, memory=mem)
        return (y, aux) if has_aux else y

    out = _Remat.apply(fn, *inputs, *p.values())
    return out if has_aux else (out, 0.0)


def forward_hidden(params: Tree, x: torch.Tensor, cfg, *,
                   sub_layers: Optional[int] = None, active_from: int = 0,
                   remat: bool = False):
    """x: (B, S, d) embedded inputs. Returns (hidden, aux_loss): the sum
    of the MoE blocks' load-balance losses, fp32 (0 without MoE blocks);
    the frozen stages' part carries no gradient."""
    topo = _ported(cfg)
    S = num_stages(cfg)
    sub = S if sub_layers is None else sub_layers
    act = max(0, min(active_from, sub))
    stack = subtree(params, "blocks")

    def inner(x, aux, st, idx, kind):
        """The stage's stacked blocks of ``st`` at row ``idx`` (group rows
        of a grouped stack), each after the other, remat as asked."""
        for i in idx:
            x, a = remat_block({k: t[i] for k, t in st.items()}, x, cfg,
                               kind, remat)
            if kind in B.MOE_KINDS:
                aux = aux + a
        return x, aux

    if topo == "uniform":
        kind = uniform_kind(cfg)

        def stage(x, aux, i):
            return inner(x, aux, stack, [i], kind)
    elif topo == "moe_il":
        mstack = subtree(params, "moe_blocks")

        def stage(x, aux, gi):
            x, aux = inner(x, aux, stack,
                           [(gi, i) for i in range(cfg.moe.moe_every - 1)],
                           "dense")
            x, a = B.block_apply({k: t[gi] for k, t in mstack.items()}, x,
                                 cfg, "moe")
            return x, aux + a
    elif topo == "xlstm":
        mstack, sstack = subtree(params, "mlstm"), subtree(params, "slstm")
        per = _xlstm_groups(cfg)[1]

        def stage(x, aux, gi):
            x, aux = inner(x, aux, mstack, [(gi, i) for i in range(per - 1)],
                           "mlstm")
            return B.block_apply({k: t[gi] for k, t in sstack.items()}, x,
                                 cfg, "slstm")[0], aux
    else:
        shared = subtree(params, "shared_attn")

        def stage(x, aux, gi):
            x, aux = inner(x, aux, stack,
                           [(gi, i) for i in range(cfg.attn_every)], "mamba")
            return B.block_apply(shared, x, cfg, "attn_only")[0], aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if act > 0:
        with torch.no_grad():
            for i in range(act):
                x, aux = stage(x, aux, i)
    for i in range(act, sub):
        x, aux = stage(x, aux, i)
    x = rmsnorm(x, params["final_ln/scale"], cfg.norm_eps)
    return x, aux


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
