"""AdamW with a freeze mask (``repro.optim.optimizers.make_adamw``).

Not ``torch.optim``: the reference adds weight decay inside the update and
multiplies the whole update by a per-leaf mask, so frozen layers do not
move even under decoupled weight decay (``optimizers.py:35-38, 61-81``).
``init(params) -> state`` and ``update(grads, state, params, lr, mask) ->
(new_params, new_state)`` work on flat ``{path: tensor}`` dicts and are
functional: they return new tensors and never write into ``params``,
which other trees (the server's model, a broadcast view) may share.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], dict]
    update: Callable[..., tuple]  # (grads, state, params, lr, mask=None)


def make_adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
               grad_clip=0.0) -> Optimizer:
    def init(params: Tree) -> dict:
        return {"mu": {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()},
                "nu": {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()},
                "count": 0}

    def update(grads: Tree, state: dict, params: Tree, lr, mask=None):
        if grad_clip:
            gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                   for g in grads.values()))
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        c = state["count"] + 1
        # bias corrections and the rate rounded to fp32, as the reference
        # computes them (each is then an exact Python scalar)
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(c))
        bc2 = float(f32(1) - f32(b2) ** f32(c))
        lr = float(f32(lr))
        mu, nu, new = {}, {}, {}
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            m = b1 * state["mu"][k] + (1 - b1) * g
            v = b2 * state["nu"][k] + (1 - b2) * torch.square(g)
            u = -lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                       + weight_decay * p.to(torch.float32))
            if mask is not None:
                u = u * mask[k]
            mu[k], nu[k] = m, v
            new[k] = (p + u).to(p.dtype)
        return new, {"mu": mu, "nu": nu, "count": c}

    return Optimizer(init, update)


def make_optimizer(train_cfg) -> Optimizer:
    if train_cfg.optimizer == "adamw":
        return make_adamw(train_cfg.b1, train_cfg.b2, train_cfg.eps,
                          train_cfg.weight_decay, train_cfg.grad_clip)
    raise NotImplementedError(
        f"optimizer '{train_cfg.optimizer}' is not ported yet (the port has "
        f"adamw; adafactor and sgdm come with a later slice)")
