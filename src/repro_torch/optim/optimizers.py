"""AdamW, Adafactor and SGD with momentum, with a freeze mask
(``repro.optim.optimizers``).

Not ``torch.optim``: the reference adds weight decay inside the update and
multiplies the whole update by a per-leaf mask, so frozen layers do not
move even under decoupled weight decay (``optimizers.py:35-38, 61-81``).
``init(params) -> state`` and ``update(grads, state, params, lr, mask) ->
(new_params, new_state)`` work on flat ``{path: tensor}`` dicts and are
functional: they return new tensors and never write into ``params``,
which other trees (the server's model, a broadcast view) may share.
States keep the reference's layouts and key paths: AdamW ``{"mu", "nu",
"count"}``, Adafactor ``{"m": {path: {"vr", "vc"} | {"v"}}, "count"}``
(factored second moments for leaves whose last two dims are both at least
``min_dim_size_to_factor``; no first moment), SGDM ``{"v"}`` with no step
count. The step count is a Python int; the scalars the reference computes
from it in fp32 (bias corrections, Adafactor's decay) are rounded to fp32
here too, so each is then an exact Python scalar.

``scalars(count, lr)`` gives an update's per-step scalars (the learning
rate and those of its step count) as such floats. ``update(...,
scalars=)`` takes them instead as 0-dim fp32 tensors on the parameters'
device, holding the same values, and gives the same bits: a step captured
as a CUDA graph reads them from the tensors at each replay, where a Python
float would stay baked in at its captured value.
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
    # (grads, state, params, lr, mask=None, scalars=None)
    update: Callable[..., tuple]
    # (count, lr) -> the scalars of the update that makes the step count
    # ``count`` (SGDM, which counts no steps, takes any)
    scalars: Callable[[int, float], Dict[str, float]]


def _divide_by(s):
    """``x -> x / s``, with the bits of a division by the float that ``s``
    holds. CUDA divides a tensor by a host scalar as a product with the
    scalar's fp32 reciprocal, so a CUDA tensor ``s`` takes that route too;
    elsewhere both divide."""
    if isinstance(s, torch.Tensor) and s.is_cuda:
        r = torch.reciprocal(s)
        return lambda x: x * r
    return lambda x: x / s


def make_adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
               grad_clip=0.0) -> Optimizer:
    def init(params: Tree) -> dict:
        return {"mu": {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()},
                "nu": {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()},
                "count": 0}

    def step_scalars(count: int, lr: float) -> Dict[str, float]:
        f32 = np.float32
        return {"lr": float(f32(lr)),
                "bc1": float(f32(1) - f32(b1) ** f32(count)),
                "bc2": float(f32(1) - f32(b2) ** f32(count))}

    def update(grads: Tree, state: dict, params: Tree, lr, mask=None,
               scalars=None):
        if grad_clip:
            gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                   for g in grads.values()))
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        c = state["count"] + 1
        s = step_scalars(c, lr) if scalars is None else scalars
        lr, over_bc1, over_bc2 = (s["lr"], _divide_by(s["bc1"]),
                                  _divide_by(s["bc2"]))
        mu, nu, new = {}, {}, {}
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            m = b1 * state["mu"][k] + (1 - b1) * g
            v = b2 * state["nu"][k] + (1 - b2) * torch.square(g)
            u = -lr * (over_bc1(m) / (torch.sqrt(over_bc2(v)) + eps)
                       + weight_decay * p.to(torch.float32))
            if mask is not None:
                u = u * mask[k]
            mu[k], nu[k] = m, v
            new[k] = (p + u).to(p.dtype)
        return new, {"mu": mu, "nu": nu, "count": c}

    return Optimizer(init, update, step_scalars)


def make_adafactor(eps=1e-30, clip_threshold=1.0, decay_rate=0.8,
                   weight_decay=0.0, min_dim_size_to_factor=128) -> Optimizer:
    """Adafactor (Shazeer & Stern, 2018): row and column means of the
    squared gradient for matrices, a full second moment otherwise; the
    update is clipped by its RMS over the whole leaf."""
    def _factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor \
            and shape[-2] >= min_dim_size_to_factor

    def init(params: Tree) -> dict:
        def leaf(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"m": {k: leaf(p) for k, p in params.items()}, "count": 0}

    def step_scalars(count: int, lr: float) -> Dict[str, float]:
        f32 = np.float32
        beta = f32(1) - f32(count) ** f32(-decay_rate)
        return {"lr": float(f32(lr)), "beta": float(beta),
                "keep": float(f32(1) - beta)}

    def update(grads: Tree, state: dict, params: Tree, lr, mask=None,
               scalars=None):
        c = state["count"] + 1
        s = step_scalars(c, lr) if scalars is None else scalars
        lr, beta, keep = s["lr"], s["beta"], s["keep"]
        new_m, new = {}, {}
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            g2 = torch.square(g) + eps
            st = state["m"][k]
            if "vr" in st:
                vr = beta * st["vr"] + keep * torch.mean(g2, dim=-1)
                vc = beta * st["vc"] + keep * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=eps)
                pre = (vr / denom)[..., None] * vc[..., None, :]
                u = g * torch.rsqrt(pre + eps)
                new_m[k] = {"vr": vr, "vc": vc}
            else:
                v = beta * st["v"] + keep * g2
                u = g * torch.rsqrt(v + eps)
                new_m[k] = {"v": v}
            # update clipping by RMS
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            upd = -lr * (u + weight_decay * p.to(torch.float32))
            if mask is not None:
                upd = upd * mask[k]
            new[k] = (p + upd).to(p.dtype)
        return new, {"m": new_m, "count": c}

    return Optimizer(init, update, step_scalars)


def make_sgdm(momentum=0.9, weight_decay=0.0) -> Optimizer:
    """SGD with momentum (the supervised FL baseline): v <- momentum v + g
    + wd p, p <- p - lr v."""
    def init(params: Tree) -> dict:
        return {"v": {k: torch.zeros_like(p, dtype=torch.float32)
                      for k, p in params.items()}}

    def step_scalars(count: int, lr: float) -> Dict[str, float]:
        return {"lr": float(np.float32(lr))}

    def update(grads: Tree, state: dict, params: Tree, lr, mask=None,
               scalars=None):
        lr = (step_scalars(0, lr) if scalars is None else scalars)["lr"]
        vs, new = {}, {}
        for k, p in params.items():
            v = momentum * state["v"][k] + grads[k].to(torch.float32) \
                + weight_decay * p.to(torch.float32)
            u = -lr * v
            if mask is not None:
                u = u * mask[k]
            vs[k] = v
            new[k] = (p + u).to(p.dtype)
        return new, {"v": vs}

    return Optimizer(init, update, step_scalars)


def make_optimizer(train_cfg) -> Optimizer:
    if train_cfg.optimizer == "adamw":
        return make_adamw(train_cfg.b1, train_cfg.b2, train_cfg.eps,
                          train_cfg.weight_decay, train_cfg.grad_clip)
    if train_cfg.optimizer == "adafactor":
        return make_adafactor(weight_decay=train_cfg.weight_decay)
    if train_cfg.optimizer == "sgdm":
        return make_sgdm(weight_decay=train_cfg.weight_decay)
    raise ValueError(train_cfg.optimizer)
