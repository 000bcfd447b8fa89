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
blocks is the ``uniform`` topology with ``mamba`` blocks (no config of the
JAX package has one; its decode parity test does).

Serving: ``init_caches`` builds every layer's decode cache (KV ring
buffers, MLA's latent caches, the Mamba2 and xLSTM states), a flat
``{path: tensor}`` dict at the paths of the reference's cache tree with
its shapes: the uniform stack's leaves (L, ...) at the top (``k``, ``v``,
``pos``, or ``c_kv``, ``k_rope``, ``pos``, or ``conv``, ``h``), zamba's
``mamba/...`` (groups, attn_every, ...) and ``attn/...`` (groups, ...),
llama4's ``dense/...`` (groups, moe_every - 1, ...) and ``moe/...``
(groups, ...), the xLSTM's ``mlstm/...`` (groups, slstm_every - 1, ...)
and ``slstm/...`` (groups, ...); so ``convert.from_numpy_tree`` carries a
reference cache across. ``decode_step`` runs one token a sequence through
every layer under ``torch.no_grad()``, writing the caches in place (the
reference donates them), and returns the logits and the caches.
``prefill`` is the full-prompt forward and its last position's logits.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.func import vjp

from repro_torch.convert import subtree
from repro_torch.federated.leaves import tree_sorted
from repro_torch.models import blocks as B
from repro_torch.models.layers.init import embed_init_
from repro_torch.models.layers.norms import rmsnorm
from repro_torch.sharding.aten import LOOKUP, collective_source, replicating

LOSS_CHUNK = 512
Tree = Dict[str, torch.Tensor]

# The reference's sequence-parallel residual stream (Korthikanti et al.),
# off by default as there: on a sharded step each block's output is laid
# out over ("data", "model") on (batch, seq), so that tensor-parallel
# output all-reduces become reduce-scatter + all-gather pairs.
SEQ_SHARD = False


def _maybe_seq_shard(x: torch.Tensor) -> torch.Tensor:
    """``x`` redistributed to the spec ("data", "model", None) when
    ``SEQ_SHARD`` is on and ``x`` is a DTensor (the reference's
    ``with_sharding_constraint``); ``x`` itself otherwise."""
    if not SEQ_SHARD or not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.rules import to_placements
    return x.redistribute(x.device_mesh, to_placements(
        ("data", "model", None), x.device_mesh))


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


def _xlstm_groups(cfg):
    """(groups, blocks a group) of the xlstm topology."""
    per = cfg.xlstm.slstm_every or cfg.num_layers
    return cfg.num_layers // per, per


def num_stages(cfg) -> int:
    """Stage granularity of the layer-wise schedule: one block (uniform),
    one group of ``attn_every`` Mamba2 blocks (zamba), of ``moe_every``
    blocks (moe_il) or of ``slstm_every`` xLSTM blocks (xlstm; one block a
    stage when ``slstm_every`` is 0, as the reference counts it)."""
    topo = topology(cfg)
    if topo == "zamba":
        return cfg.num_layers // cfg.attn_every
    if topo == "moe_il":
        return cfg.num_layers // cfg.moe.moe_every
    if topo == "xlstm" and cfg.xlstm.slstm_every:
        return cfg.num_layers // cfg.xlstm.slstm_every
    return cfg.num_layers


def lm_shapes(cfg) -> Dict[str, tuple]:
    topo = topology(cfg)
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
    table = params["embed"]
    if isinstance(table, DTensor):
        x = _ShardedLookup.apply(table, tokens)
    else:
        x = table[tokens]
    x = x * math.sqrt(cfg.d_model)
    if frontend is not None:
        x = torch.cat([frontend.to(x.dtype), x], dim=1)
    return x


class _ShardedLookup(torch.autograd.Function):
    """The token lookup of a sharded step, as data parallelism does it:
    the table gathered whole (replicated), each device's rows looked up
    from its own tokens (the result laid out as the tokens, the model dim
    whole), and in the backward each device's gradient rows added into a
    whole-table gradient that is a partial sum over the mesh dims that
    split the tokens. DTensor's own index strategies are left out: their
    backward's layouts differ between torch versions and fail on some. The
    table's gather (the whole table on every device, in decode too) is the
    port's choice, not the rules': its collectives are filed under
    ``LOOKUP``."""

    @staticmethod
    def forward(ctx, table, tokens):
        from torch.distributed.tensor import Partial, Replicate, Shard
        mesh = table.device_mesh
        if not isinstance(tokens, DTensor):
            tokens = DTensor.from_local(tokens, mesh,
                                        [Replicate()] * mesh.ndim)
        with collective_source(LOOKUP):
            whole = table.redistribute(mesh, [Replicate()] * mesh.ndim)
        tok = tokens.to_local()
        pl = tuple(p if isinstance(p, Shard) and p.dim < tokens.ndim
                   else Replicate() for p in tokens.placements)
        ctx.save_for_backward(tok)
        ctx.meta = (mesh, pl, tuple(table.shape), table.stride(),
                    tuple(p if p == Replicate() else Partial()
                          for p in pl))
        out = whole.to_local()[tok]
        shape = tuple(tokens.shape) + out.shape[-1:]
        return DTensor.from_local(out, mesh, pl, run_check=False,
                                  shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    @staticmethod
    def backward(ctx, g):
        (tok,) = ctx.saved_tensors
        mesh, pl, shape, stride, gpl = ctx.meta
        with collective_source(LOOKUP):
            local = g.redistribute(mesh, pl).to_local()
        grad = torch.zeros(shape, dtype=local.dtype, device=local.device)
        grad.index_put_((tok,), local, accumulate=True)
        return DTensor.from_local(grad, mesh, gpl, run_check=False,
                                  shape=shape, stride=stride), None


def _head_matrix(params: Tree, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


class _Remat(torch.autograd.Function):
    """Rematerialisation of one block: the forward keeps only its inputs,
    and the backward recomputes the block inside ``torch.func.vjp``. It
    works under autograd, under the LM vmap engine's vmapped forward with
    its backward outside (the generated ``vmap`` rule vmaps this backward)
    and under ``torch.func.grad`` alike; ``torch.utils.checkpoint`` does
    not, since the ``torch.func`` transforms refuse its saved-tensor
    hooks. ``fn`` returns a tensor, or
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
        with replicating(*ctx.saved_tensors):
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
    topo = topology(cfg)
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
            x = _maybe_seq_shard(x)
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
        if isinstance(logits, DTensor):
            # the reference's XENT_GOLD_MODE "mask": the same value (one
            # logit plus zeros), and the logits stay sharded over the
            # vocabulary, where an index would gather them
            hot = yc[..., None].long() == torch.arange(
                logits.shape[-1], device=logits.device)
            gold = torch.sum(logits * hot, dim=-1)
        else:
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


# -- serving ------------------------------------------------------------------
def _cache_stacks(cfg):
    """(cache prefix, block kind, stack dims) of each cache stack."""
    topo = topology(cfg)
    if topo == "uniform":
        return [("", uniform_kind(cfg), (cfg.num_layers,))]
    g = num_stages(cfg)
    if topo == "zamba":
        return [("mamba/", "mamba", (g, cfg.attn_every)),
                ("attn/", "attn_only", (g,))]
    if topo == "moe_il":
        return [("dense/", "dense", (g, cfg.moe.moe_every - 1)),
                ("moe/", "moe", (g,))]
    g, per = _xlstm_groups(cfg)
    return [("mlstm/", "mlstm", (g, per - 1)), ("slstm/", "slstm", (g,))]


def _fix_pos(tree: Tree) -> Tree:
    """Attention caches' ``pos`` leaves set to -1 (an empty slot), for
    caches stacked from zeros."""
    return {k: torch.full_like(t, -1) if k.rsplit("/", 1)[-1] == "pos"
            else t for k, t in tree.items()}


def init_caches(cfg, batch: int, seq_len: int, dtype=None,
                device="cpu") -> Tree:
    """Every layer's decode cache for ``batch`` sequences of up to
    ``seq_len`` positions; attention caches in ``dtype`` (default the
    compute dtype), recurrent states in fp32."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    caches = {}
    for prefix, kind, dims in _cache_stacks(cfg):
        one = B.block_cache_init(cfg, kind, batch, seq_len, dtype, device)
        # broadcast, not zeros: the recurrent states start at non-zero
        # values (the mLSTM stabiliser m = -1e30, the sLSTM normaliser 1)
        caches.update({f"{prefix}{k}": t.expand(*dims, *t.shape).clone(
            memory_format=torch.contiguous_format) for k, t in one.items()})
    return tree_sorted(caches)


def decode_block(p: Tree, x: torch.Tensor, layer: Tree, pos: int, cfg,
                 kind: str, memory: Optional[torch.Tensor] = None):
    """One block's decode step against ``layer``, the block's rows of the
    cache stacks (views), into which its new state is written."""
    x, new = B.block_decode(p, x, layer, pos, cfg, kind, memory)
    for k, t in new.items():
        if t is not layer[k]:
            layer[k].copy_(t)
    return x


def _rows(stack: Tree, i) -> Tree:
    return {k: t[i] for k, t in stack.items()}


@torch.no_grad()
def decode_step(params: Tree, caches: Tree, token: torch.Tensor, pos: int,
                cfg):
    """token: (B, 1) int, at position ``pos`` (a Python int). Returns
    (logits (B, 1, V) fp32, caches), the caches written in place."""
    x = embed(params, token, cfg)
    topo = topology(cfg)
    if topo == "uniform":
        stack, kind = subtree(params, "blocks"), uniform_kind(cfg)
        for i in range(cfg.num_layers):
            x = decode_block(_rows(stack, i), x, _rows(caches, i), pos, cfg,
                             kind)
    else:
        # each group: ``per`` inner blocks, then the group's last block
        # (zamba's shared one, llama4's MoE one, the xLSTM's sLSTM)
        (pre, kind, (g, per)), (lpre, last, _) = _cache_stacks(cfg)
        inner = subtree(params, "mlstm" if topo == "xlstm" else "blocks")
        outer = subtree(params, {"zamba": "shared_attn",
                                 "moe_il": "moe_blocks",
                                 "xlstm": "slstm"}[topo])
        cin, clast = subtree(caches, pre[:-1]), subtree(caches, lpre[:-1])
        for gi in range(g):
            for j in range(per):
                x = decode_block(_rows(inner, (gi, j)), x,
                                 _rows(cin, (gi, j)), pos, cfg, kind)
            p = outer if topo == "zamba" else _rows(outer, gi)
            x = decode_block(p, x, _rows(clast, gi), pos, cfg, last)
    x = rmsnorm(x, params["final_ln/scale"], cfg.norm_eps)
    cdt = getattr(torch, cfg.compute_dtype)
    logits = x.to(cdt) @ _head_matrix(params, cfg).to(cdt)
    return logits.to(torch.float32), caches


@torch.no_grad()
def prefill(params: Tree, tokens: torch.Tensor, cfg,
            frontend: Optional[torch.Tensor] = None):
    """The full prompt's forward. Returns (the last position's logits (B,
    1, V) fp32, the hidden states (B, S, d)). As in the reference, it
    hands no cache to ``decode_step``, which serving steps over the
    prompt instead."""
    x = embed(params, tokens, cfg, frontend)
    hidden, _ = forward_hidden(params, x, cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    logits = hidden[:, -1:].to(cdt) @ _head_matrix(params, cfg).to(cdt)
    return logits.to(torch.float32), hidden
