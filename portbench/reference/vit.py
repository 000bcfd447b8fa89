"""Plain reference of the ViT cells: ViT-Tiny with MoCo v3 and the Eq. 3
alignment, trained layer-wise over FL rounds (the paper's Algorithms 1
and 2 as the port runs them).

A round: every client trains from the server's online model (its target
branch restarting from it) for its batch plan, all clients' steps batched
under ``torch.func.vmap`` with one ``torch.autograd.grad`` of the summed
losses; FedAvg over their online trees; then, where the plan calibrates,
the server trains the whole sub-model on its auxiliary images with a fresh
AdamW. Blocks below ``active_from`` run under ``torch.no_grad()``; the
target branch and the global encoder of the alignment never get gradients.
The draws (cohort, batches, views) and the starting weights come from the
benchmark's seed, as the program gets them.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.func import vmap

from portbench.lib import draws as D
from portbench.reference import augment
from portbench.reference.common import (AdamW, Numerics, client_weights,
                                        fedavg, info_nce, learning_rate, mlp,
                                        rmsnorm, self_attention, transfer,
                                        update_mask)

Tree = Dict[str, torch.Tensor]
PATCH = 4


def sub(tree: Tree, prefix: str) -> Tree:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in tree.items() if k.startswith(prefix + "/")}


def encoder(p: Tree, images, cfg, num: Numerics, sub_layers: int,
            active_from: int):
    """images (B, 32, 32, 3) -> the CLS representation (B, d)."""
    B, H, W, C = images.shape
    x = images.reshape(B, H // PATCH, PATCH, W // PATCH, PATCH, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, -1, PATCH * PATCH * C)
    x = x @ p["patch"]
    x = torch.cat([p["cls"].expand(B, 1, cfg["d_model"]), x], 1) + p["pos"][None]
    blocks = sub(p, "blocks")
    act = max(0, min(active_from, sub_layers))

    def block(x, i):
        b = {k: t[i] for k, t in blocks.items()}
        y = x + self_attention(sub(b, "attn"), rmsnorm(
            x, b["ln1/scale"], cfg["norm_eps"]), cfg, num, causal=False)
        y = y + mlp(sub(b, "mlp"), rmsnorm(y, b["ln2/scale"], cfg["norm_eps"]),
                    cfg["act"], num)
        return x + 1.0 * (y - x)        # the port's gated residual, gate 1

    with torch.no_grad():
        for i in range(act):
            x = block(x, i)
    for i in range(act, sub_layers):
        x = block(x, i)
    return rmsnorm(x, p["final_ln/scale"], cfg["norm_eps"])[:, 0]


def head(p: Tree, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """MLP head in fp32: each layer a product, BatchNorm on the batch's
    own statistics (population variance), ReLU on all but the last."""
    n = sum(1 for k in p if k.endswith("/w"))
    for i in range(n):
        x = x.to(torch.float32) @ p[f"layers/{i}/w"]
        mu = torch.mean(x, dim=0, keepdim=True)
        var = torch.var(x, dim=0, keepdim=True, unbiased=False)
        x = (x - mu) * torch.rsqrt(var + eps) * p[f"layers/{i}/bn/scale"] \
            + p[f"layers/{i}/bn/bias"]
        if i < n - 1:
            x = F.relu(x)
    return x


def ssl_loss(online: Tree, target: Tree, x1, x2, cfg, ssl, num, *,
             sub_layers: int, active_from: int, global_enc=None):
    """MoCo v3's symmetrised InfoNCE between the online branch's
    predictions and the target's projections, plus the alignment of the
    online representations with the global encoder's when given."""
    tau = ssl["temperature"]
    enc, proj, pred = sub(online, "enc"), sub(online, "proj"), \
        sub(online, "pred")
    z1 = encoder(enc, x1, cfg, num, sub_layers, active_from)
    z2 = encoder(enc, x2, cfg, num, sub_layers, active_from)
    q1, q2 = head(pred, head(proj, z1)), head(pred, head(proj, z2))
    with torch.no_grad():
        t_enc, t_proj = sub(target, "enc"), sub(target, "proj")
        k1 = head(t_proj, encoder(t_enc, x1, cfg, num, sub_layers, sub_layers))
        k2 = head(t_proj, encoder(t_enc, x2, cfg, num, sub_layers, sub_layers))
    loss = info_nce(q1, k2, tau) + info_nce(q2, k1, tau)
    if global_enc is not None:
        with torch.no_grad():
            g1 = encoder(global_enc, x1, cfg, num, sub_layers, 0)
            g2 = encoder(global_enc, x2, cfg, num, sub_layers, 0)
        loss = loss + ssl["align_weight"] * (info_nce(z1, g2, tau)
                                             + info_nce(z2, g1, tau))
    return loss


def step(state, opt, opt_state, x1, x2, lr, cfg, ssl, num, *, sub_layers,
         active_from, global_enc=None, clients: bool, record=None):
    """One masked AdamW step on the SSL loss, then the target EMA. With
    ``clients`` every tensor of ``state`` and the views carry a leading
    client axis, and the losses are taken under ``vmap``. An empty dict
    ``record`` gets each leaf's gradient norm (over the clients)."""
    online = {k: v.detach().requires_grad_() for k, v in state["online"].items()}

    def loss_fn(online, target, x1, x2):
        return ssl_loss(online, target, x1, x2, cfg, ssl, num,
                        sub_layers=sub_layers, active_from=active_from,
                        global_enc=global_enc)

    f = vmap(loss_fn) if clients else loss_fn
    losses = f(online, state["target"], x1, x2)
    grads = torch.autograd.grad(losses.sum(), list(online.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(online.items(), grads)}
    mask = update_mask(state["online"], sub_layers, active_from,
                       lead=1 if clients else 0)
    if record is not None and not record:
        record.update({k: float(torch.linalg.vector_norm(g))
                       for k, g in grads.items()})
    new, opt_state = opt.update(grads, opt_state, state["online"], lr, mask)
    mu = ssl["momentum"]
    target = {k: mu * t + (1.0 - mu) * new[k]
              for k, t in state["target"].items()}
    return {"online": new, "target": target}, opt_state, losses.detach()


def layout(cfg, ssl, image_size: int = 32):
    """{path: (shape, float32)} of the online branch: the ViT under
    ``enc/`` (stacked blocks, patch embedding, positions, CLS, final norm),
    the projection head (d, hidden, hidden, out) and the prediction head
    (out, hidden, out), each layer a product and a BatchNorm."""
    L, d, ff = cfg["num_layers"], cfg["d_model"], cfg["d_ff"]
    hd = cfg["head_dim"] or d // cfg["num_heads"]
    n = (image_size // PATCH) ** 2
    shapes = {"enc/blocks/attn/wk": (L, d, cfg["num_kv_heads"] * hd),
              "enc/blocks/attn/wo": (L, cfg["num_heads"] * hd, d),
              "enc/blocks/attn/wq": (L, d, cfg["num_heads"] * hd),
              "enc/blocks/attn/wv": (L, d, cfg["num_kv_heads"] * hd),
              "enc/blocks/ln1/scale": (L, d), "enc/blocks/ln2/scale": (L, d),
              "enc/blocks/mlp/w_down": (L, ff, d),
              "enc/blocks/mlp/w_up": (L, d, ff),
              "enc/cls": (1, 1, d), "enc/final_ln/scale": (d,),
              "enc/patch": (PATCH * PATCH * 3, d), "enc/pos": (n + 1, d)}
    heads = {"pred": (ssl["proj_dim"], ssl["pred_hidden"], ssl["proj_dim"]),
             "proj": (d, ssl["proj_hidden"], ssl["proj_hidden"],
                      ssl["proj_dim"])}
    for name, dims in heads.items():
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            shapes[f"{name}/layers/{i}/bn/bias"] = (b,)
            shapes[f"{name}/layers/{i}/bn/scale"] = (b,)
            shapes[f"{name}/layers/{i}/w"] = (a, b)
    return {k: (s, torch.float32) for k, s in shapes.items()}


def init_state(layout, seed, device, weights) -> Tree:
    """The starting state: the online branch drawn by ``weights``, the
    target branch a copy of its encoder and projection head."""
    online = weights(layout, seed, device)
    target = {k: v.clone() for k, v in online.items()
              if not k.startswith("pred/")}
    return {"online": online, "target": target}


def follow(inputs, plan_for, rounds: int, cfg, ssl, train, fl, *,
           num: Numerics, seed: int, state, fault=None, grads=None):
    """``rounds`` FL rounds from ``state`` (after the stage transfer);
    returns [(the clients' losses, the FedAvg aggregate, the state after
    the round)]. ``inputs``
    holds the pool ``images``, the clients' index tensors ``shards`` and
    the server's ``aux`` images; ``plan_for(r)`` is round r's plan.
    ``fault`` names a fault to plant (the checks' own readings): ``half``
    takes each loss over the first half of the batch, ``noavg`` keeps
    client 0's tree for the aggregate, ``upload`` doubles client 0's
    update before FedAvg, ``answer`` doubles the aggregate's update of its
    first leaf. ``grads``, a dict, gets the leaves' gradient
    norms at the first local step (``local``) and the first calibration
    step (``server``)."""
    grads = {} if grads is None else grads
    grads.update(local={}, server={})
    dev = inputs["images"].device
    _, H, W, _ = inputs["images"].shape
    opt = AdamW(train["b1"], train["b2"], train["eps"], train["weight_decay"])
    base_lr = train["base_lr"] * train["batch_size"] / 256.0
    B = train["batch_size"]
    counts = [len(ix) for ix in inputs["shards"]]
    out = []
    for r in range(rounds):
        p = plan_for(r)
        if p.new_stage and fl["weight_transfer"]:
            state = {br: transfer(t, p.stage, "enc/") for br, t in state.items()}
        lr = learning_rate(r, fl["rounds"], base_lr)
        who = D.cohort(seed, dev, r, fl["num_clients"], fl["clients_per_round"]
                       or fl["num_clients"])
        plans = [D.batch_plan(seed, dev, r, k, counts[c], fl["local_epochs"], B)
                 for k, c in enumerate(who)]
        if len({len(b) for b in plans}) != 1:
            raise ValueError("the reference takes equal shards")
        g = state["online"]
        C = len(who)
        cst = {"online": {k: v.expand(C, *v.shape).clone() for k, v in g.items()},
               "target": {k: g[k].expand(C, *g[k].shape).clone()
                          for k in state["target"]}}
        ost = opt.init(cst["online"])
        genc = sub(g, "enc") if p.align else None
        for t in range(len(plans[0])):
            v1, v2 = [], []
            for c, bp in zip(who, plans):
                idx, handle = bp[t]
                imgs = inputs["images"][inputs["shards"][c][idx]]
                d1, d2 = D.views(seed, dev, handle, len(idx), H, W)
                if fault == "half":
                    imgs, d1, d2 = imgs[:B // 2], _half(d1), _half(d2)
                v1.append(augment.augment(imgs, d1))
                v2.append(augment.augment(imgs, d2))
            cst, ost, losses = step(
                cst, opt, ost, torch.stack(v1), torch.stack(v2), lr, cfg,
                ssl, num, sub_layers=p.sub_layers, active_from=p.active_from,
                global_enc=genc, clients=True, record=grads["local"])
        trees = [{k: v[c] for k, v in cst["online"].items()} for c in range(C)]
        if fault == "upload":
            trees[0] = {k: 2 * v - g[k] for k, v in trees[0].items()}
        online = trees[0] if fault == "noavg" else fedavg(
            trees, client_weights([counts[c] for c in who]))
        if fault == "answer":
            k = min(online)
            online = {**online, k: 2 * online[k] - g[k]}
        state = {**state, "online": online}
        if p.server_calibrate:
            state = calibrate(state, inputs["aux"], p, lr, cfg, ssl, num, opt,
                              seed, r, fl, B, fault, grads["server"])
        out.append(([float(x) for x in losses], online, state))
    return out


def _half(d):
    return {k: v[:len(v) // 2] for k, v in d.items()}


def calibrate(state, aux, p, lr, cfg, ssl, num, opt, seed, r, fl, B, fault,
              record=None):
    """The server's calibration: the whole sub-model trained end to end on
    the auxiliary images with a fresh optimizer state."""
    _, H, W, _ = aux.shape
    ost = opt.init(state["online"])
    n = aux.shape[0]
    for idx, handle in D.batch_plan(seed, aux.device, r, "server", n,
                                    fl["server_epochs"], min(B, n)):
        imgs = aux[idx]
        d1, d2 = D.views(seed, aux.device, handle, len(idx), H, W)
        if fault == "half":
            imgs, d1, d2 = imgs[:len(idx) // 2], _half(d1), _half(d2)
        state, ost, _ = step(state, opt, ost, augment.augment(imgs, d1),
                             augment.augment(imgs, d2), lr, cfg, ssl, num,
                             sub_layers=p.sub_layers, active_from=0,
                             clients=False, record=record)
    return state


def flat(state) -> Tree:
    """The state as one flat tree, branches as the first path entry."""
    return {f"{br}/{k}": v for br, t in state.items() for k, v in t.items()}
