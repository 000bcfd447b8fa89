"""Client-side local SSL training (paper Algorithm 2;
``repro.federated.client``).

``train_step`` is one optimizer step of the SSL loss; ``local_train`` runs
a client's batch plan over its shard. The online branch, target branch and
optimizer state are local to the client for the round; the target branch
starts from the downloaded global model (Algorithm 2, lines 2-3).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import schedule as sched
from repro_torch.core import ssl as ssl_mod
from repro_torch.data.augment import two_views
from repro_torch.federated.masks import stage_update_mask

Tree = Dict[str, torch.Tensor]


def train_step(state, opt_state, x1, x2, lr: float, *, encoder, ssl_cfg,
               opt, sub_layers: int, active_from: int, layer_gates=None,
               global_enc: Optional[Tree] = None, align_weight: float = 0.0):
    """One masked optimizer step of ``ssl_loss`` on the views (x1, x2),
    then the target EMA. Returns (state, opt_state, metrics)."""
    online = {k: v.detach().requires_grad_() for k, v in
              state["online"].items()}
    loss, metrics = ssl_mod.ssl_loss(
        {**state, "online": online}, x1, x2, encoder, ssl_cfg,
        sub_layers=sub_layers, active_from=active_from,
        layer_gates=layer_gates, global_enc=global_enc,
        align_weight=align_weight)
    grads = torch.autograd.grad(loss, list(online.values()),
                                allow_unused=True)
    # a leaf the loss does not reach (frozen embedding) has a zero gradient
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(state["online"].items(), grads)}
    mask = stage_update_mask(state["online"], sub_layers, active_from)
    new_online, opt_state = opt.update(grads, opt_state, state["online"], lr,
                                       mask)
    state = ssl_mod.momentum_update({**state, "online": new_online},
                                    ssl_cfg.momentum)
    return state, opt_state, {k: v.detach() for k, v in metrics.items()}


def local_train(global_state, images: torch.Tensor, plan, draws, opt, *,
                encoder, ssl_cfg, lr: float, sub_layers: int,
                active_from: int, align: bool, depth_dropout: float,
                global_enc: Optional[Tree] = None):
    """Run one client's batch plan (from ``draws.batch_plan``) over its
    shard ``images`` (n_i, H, W, 3). Returns (online params, last metrics
    with the step count)."""
    state = {"online": dict(global_state["online"]),
             # target re-initialised from the global model each round
             "target": {k: global_state["online"][k]
                        for k in global_state["target"]}}
    opt_state = opt.init(state["online"])
    align_w = ssl_cfg.align_weight if align else 0.0
    _, H, W, _ = images.shape
    last = {}
    for idx, handle in plan:
        batch = images[idx]
        x1, x2 = two_views(batch, *draws.views(handle, batch.shape[0], H, W))
        gates = None
        if depth_dropout > 0.0:
            gates = sched.depth_dropout_gates(
                draws.gate_uniforms(handle, encoder.num_stages),
                active_from, depth_dropout)
        state, opt_state, last = train_step(
            state, opt_state, x1, x2, lr, encoder=encoder, ssl_cfg=ssl_cfg,
            opt=opt, sub_layers=sub_layers, active_from=active_from,
            layer_gates=gates, global_enc=global_enc, align_weight=align_w)
    return state["online"], {**last, "steps": len(plan)}
