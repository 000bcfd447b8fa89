"""Client-side local SSL training (paper Algorithm 2;
``repro.federated.client``).

``train_step`` is one optimizer step of the SSL loss; ``local_train`` runs
a client's batch plan over its shard. The online branch, target branch and
optimizer state are local to the client for the round; the target branch
starts from the downloaded global model (Algorithm 2, lines 2-3).
``stacked_train_step`` is the same step for a stack of clients at once (the
vectorised engine's): the clients' forwards under ``torch.func.vmap``, then
one ``torch.autograd.grad`` of their summed losses, which frees the
backward's intermediates as it goes, as ``train_step``'s does.
``lm_train_step`` is the LM family's step (``lm_ssl_loss``; no target
branch).

``tracer=`` (a ``repro_torch.obs`` tracer; the no-op by default) records
a step's phases as the spans ``step.forward`` (the loss), ``step.backward``
(its gradient) and ``step.update`` (the masked optimizer step and the
target EMA); ``local_train`` records each step as a ``local_step`` (its
``t``) holding ``step.views`` (the batch's draws and augmentation) and
those three. The spans wrap the ``torch.func.vmap`` calls of the stacked
step, never open inside them. ``lm_train_step`` records the last three
(``run_lm_fedssl``'s sequential loop wraps each in a ``local_step``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
from torch.func import vmap

from repro_torch.core import schedule as sched
from repro_torch.core import ssl as ssl_mod
from repro_torch.data.augment import two_views
from repro_torch.federated.masks import stage_update_mask, trained_leaves
from repro_torch.models import lm as lm_mod
from repro_torch.obs.trace import NOOP_TRACER

Tree = Dict[str, torch.Tensor]


def grads_of(loss: torch.Tensor, leaves: Tree) -> Tree:
    """``torch.autograd.grad`` of ``loss`` for each autograd leaf of
    ``leaves``; a leaf the loss does not reach (the frozen embedding) has a
    zero gradient."""
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), grads)}


def loss_and_grads(state, x1, x2, *, encoder, ssl_cfg, sub_layers: int,
                   active_from: int, layer_gates=None,
                   global_enc: Optional[Tree] = None,
                   align_weight: float = 0.0, tracer=NOOP_TRACER):
    """``ssl_loss`` on the views (x1, x2) and its gradient for each leaf of
    the online branch. Returns (loss, metrics, grads)."""
    online = {k: v.detach().requires_grad_() for k, v in
              state["online"].items()}
    with tracer.span("step.forward", cat="step"):
        loss, metrics = ssl_mod.ssl_loss(
            {**state, "online": online}, x1, x2, encoder, ssl_cfg,
            sub_layers=sub_layers, active_from=active_from,
            layer_gates=layer_gates, global_enc=global_enc,
            align_weight=align_weight)
    with tracer.span("step.backward", cat="step"):
        grads = grads_of(loss, online)
    return loss.detach(), metrics, grads


def train_step(state, opt_state, x1, x2, lr: float, *, encoder, ssl_cfg,
               opt, sub_layers: int, active_from: int, layer_gates=None,
               global_enc: Optional[Tree] = None, align_weight: float = 0.0,
               tracer=NOOP_TRACER, mask: Optional[Tree] = None,
               scalars=None):
    """One masked optimizer step of ``ssl_loss`` on the views (x1, x2),
    then the target EMA. Returns (state, opt_state, metrics). ``mask``
    (``stage_update_mask``'s, built here when None) and ``scalars`` (the
    optimizer's per-step scalars as device tensors, ``Optimizer.update``)
    let a step captured as a CUDA graph take them from outside."""
    _, metrics, grads = loss_and_grads(
        state, x1, x2, encoder=encoder, ssl_cfg=ssl_cfg,
        sub_layers=sub_layers, active_from=active_from,
        layer_gates=layer_gates, global_enc=global_enc,
        align_weight=align_weight, tracer=tracer)
    with tracer.span("step.update", cat="step"):
        state, opt_state = _apply_update(state, opt_state, grads, lr,
                                         ssl_cfg=ssl_cfg, opt=opt,
                                         sub_layers=sub_layers,
                                         active_from=active_from, mask=mask,
                                         scalars=scalars)
    return state, opt_state, {k: v.detach() for k, v in metrics.items()}


def _apply_update(state, opt_state, grads, lr, *, ssl_cfg, opt,
                  sub_layers: int, active_from: int, mask=None,
                  scalars=None):
    """The masked optimizer step on the online branch, then the target
    EMA (Algorithm 2, lines 14-15)."""
    if mask is None:
        mask = stage_update_mask(state["online"], sub_layers, active_from)
    new_online, opt_state = opt.update(grads, opt_state, state["online"], lr,
                                       mask, scalars=scalars)
    state = ssl_mod.momentum_update({**state, "online": new_online},
                                    ssl_cfg.momentum)
    return state, opt_state


def shared_opt_state(opt_state) -> tuple:
    """(per-leaf state, the entries the clients share): an optimizer
    state's step count (AdamW's and Adafactor's; SGDM has none) is one
    Python int for every client of a stack."""
    shared = {k: v for k, v in opt_state.items() if k == "count"}
    return {k: v for k, v in opt_state.items() if k not in shared}, shared


def stacked_opt_init(opt, params: Tree) -> dict:
    """``opt.init`` for each client of the client-stacked ``params``, under
    ``torch.func.vmap`` so that it sees per-client shapes (Adafactor
    decides whether to factor a leaf from its last two dims)."""
    shared = {}

    def one(p):
        per_leaf, s = shared_opt_state(opt.init(p))
        shared.update(s)
        return per_leaf

    return {**vmap(one)(params), **shared}


def stacked_loss_and_grads(state, x1, x2, *, encoder, ssl_cfg,
                           sub_layers: int, active_from: int,
                           layer_gates=None,
                           global_enc: Optional[Tree] = None,
                           align_weight: float = 0.0, tracer=NOOP_TRACER):
    """``loss_and_grads`` for C clients in one call: the losses' forward
    under ``torch.func.vmap`` over the clients, then one
    ``torch.autograd.grad`` of their sum, which frees the backward's
    intermediates as it goes. Client c's loss reads only row c of each
    stacked leaf, so row c of the sum's gradient is the gradient of loss
    c. ``state``, the views and ``layer_gates`` carry a leading client
    axis; ``global_enc`` is shared. Returns (losses (C,), grads)."""
    online = {k: v.detach().requires_grad_() for k, v in
              state["online"].items()}
    rest = {br: t for br, t in state.items() if br != "online"}

    def loss_fn(online, rest, x1, x2, gates):
        return ssl_mod.ssl_loss(
            {**rest, "online": online}, x1, x2, encoder, ssl_cfg,
            sub_layers=sub_layers, active_from=active_from,
            layer_gates=gates, global_enc=global_enc,
            align_weight=align_weight)[0]

    gates_dim = None if layer_gates is None else 0
    with tracer.span("step.forward", cat="step"):
        losses = vmap(loss_fn, in_dims=(0, 0, 0, 0, gates_dim))(
            online, rest, x1, x2, layer_gates)
    with tracer.span("step.backward", cat="step"):
        grads = grads_of(losses.sum(), online)
    return losses.detach(), grads


def stacked_train_step(state, opt_state, x1, x2, lr: float, *, encoder,
                       ssl_cfg, opt, sub_layers: int, active_from: int,
                       layer_gates=None, global_enc: Optional[Tree] = None,
                       align_weight: float = 0.0, tracer=NOOP_TRACER):
    """``train_step`` for C clients in one call: ``stacked_loss_and_grads``,
    then the masked update and the target EMA under ``torch.func.vmap``
    (per-client shapes, for Adafactor). Every tensor of ``state`` and
    ``opt_state`` (``stacked_opt_init``), the views (C, B, H, W, 3) and
    ``layer_gates`` (C, L) carry a leading client axis; ``global_enc``,
    ``lr`` and the optimizer's step count are shared. Returns (state,
    opt_state, losses (C,))."""
    losses, grads = stacked_loss_and_grads(
        state, x1, x2, encoder=encoder, ssl_cfg=ssl_cfg,
        sub_layers=sub_layers, active_from=active_from,
        layer_gates=layer_gates, global_enc=global_enc,
        align_weight=align_weight, tracer=tracer)
    per_leaf, shared = shared_opt_state(opt_state)
    new_shared = {}

    def update(state, per_leaf, grads):
        state, new_opt = _apply_update(
            state, {**per_leaf, **shared}, grads, lr, ssl_cfg=ssl_cfg,
            opt=opt, sub_layers=sub_layers, active_from=active_from)
        new_leaf, s = shared_opt_state(new_opt)
        new_shared.update(s)
        return state, new_leaf

    with tracer.span("step.update", cat="step"):
        state, per_leaf = vmap(update)(state, per_leaf, grads)
    return state, {**per_leaf, **new_shared}, losses


def lm_step_leaves(params: Tree, cfg, sub_layers: int,
                   active_from: int) -> List[str]:
    """The leaves an LM step differentiates and updates: every leaf, or in
    the zamba2 topology (one leaf a row, ``lm.leaf_stages``) only those
    the stage trains, so that gradients and the optimizer's state hold the
    stage's rows alone."""
    stages = lm_mod.leaf_stages(cfg)
    if not stages:
        return list(params)
    return trained_leaves(params, sub_layers, active_from, stages)


def lm_train_step(params: Tree, opt_state, batch, lr: float, *, cfg, opt,
                  sub_layers: int, active_from: int,
                  global_params: Optional[Tree] = None,
                  align_weight: float = 0.0, tracer=NOOP_TRACER):
    """One masked optimizer step of ``lm_ssl_loss`` on ``batch`` (the
    reference's LM ``train_step``), over the leaves of ``lm_step_leaves``
    (``opt_state`` is the optimizer's state of those); the other leaves are
    frozen and come back as they went in, as the masked update leaves
    them. ``tracer`` records ``step.forward``, ``step.backward`` and
    ``step.update`` (and the forwards' ``shared_block`` spans). Returns
    (params, opt_state, metrics)."""
    keys = lm_step_leaves(params, cfg, sub_layers, active_from)
    p = dict(params)
    p.update({k: params[k].detach().requires_grad_() for k in keys})
    with tracer.span("step.forward", cat="step"):
        loss, metrics = ssl_mod.lm_ssl_loss(
            p, batch, cfg, sub_layers=sub_layers, active_from=active_from,
            global_params=global_params, align_weight=align_weight,
            tracer=tracer)
    with tracer.span("step.backward", cat="step"):
        grads = grads_of(loss, {k: p[k] for k in keys})
    with tracer.span("step.update", cat="step"):
        trained = {k: params[k] for k in keys}
        mask = stage_update_mask(trained, sub_layers, active_from,
                                 lm_mod.leaf_stages(cfg))
        new, opt_state = opt.update(grads, opt_state, trained, lr, mask)
    return ({**params, **new}, opt_state,
            {k: v.detach() for k, v in metrics.items()})


def local_train(global_state, images: torch.Tensor, plan, draws, opt, *,
                encoder, ssl_cfg, lr: float, sub_layers: int,
                active_from: int, align: bool, depth_dropout: float,
                global_enc: Optional[Tree] = None, probe=None,
                tracer=NOOP_TRACER):
    """Run one client's batch plan (from ``draws.batch_plan``) over its
    shard ``images`` (n_i, H, W, 3). Returns (online params, last metrics
    with the step count). ``probe`` (resource measurement) is held around
    the first step and told its batch size."""
    state = {"online": dict(global_state["online"])}
    if "target" in global_state:
        # target re-initialised from the global model each round
        state["target"] = {k: global_state["online"][k]
                           for k in global_state["target"]}
    opt_state = opt.init(state["online"])
    align_w = ssl_cfg.align_weight if align else 0.0
    _, H, W, _ = images.shape
    last = {}
    for n, (idx, handle) in enumerate(plan):
        with tracer.span("local_step", cat="step", t=n):
            with tracer.span("step.views", cat="step"):
                batch = images[idx]
                x1, x2 = two_views(batch, *draws.views(handle, batch.shape[0],
                                                       H, W))
            gates = None
            if depth_dropout > 0.0:
                gates = sched.depth_dropout_gates(
                    draws.gate_uniforms(handle, encoder.num_stages),
                    active_from, depth_dropout)
            counted = probe if probe is not None and n == 0 else None
            with counted if counted is not None else contextlib.nullcontext():
                state, opt_state, last = train_step(
                    state, opt_state, x1, x2, lr, encoder=encoder,
                    ssl_cfg=ssl_cfg, opt=opt, sub_layers=sub_layers,
                    active_from=active_from, layer_gates=gates,
                    global_enc=global_enc, align_weight=align_w,
                    tracer=tracer)
        if counted is not None:
            counted.samples = batch.shape[0]
    return state["online"], {**last, "steps": len(plan)}
