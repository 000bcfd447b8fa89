"""Plain reference of the LM cells: Zamba2 (groups of Mamba2 blocks, each
group followed by one shared attention + SwiGLU block), trained
layer-wise over FL rounds on next-token cross-entropy plus the Eq. 3
alignment of its mean-pooled hidden states with the downloaded global
model's (the port's ``run_lm_fedssl``).

A round: each client in turn takes its local steps from the server's
model, one masked AdamW step per batch of its shard; FedAvg over their
trees. The Mamba2 scan is the chunked SSD form in float32 and its
gradient is autograd's through it.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.common import (AdamW, Numerics, client_weights,
                                        fedavg, info_nce, learning_rate, mlp,
                                        rmsnorm, self_attention, transfer,
                                        update_mask)

Tree = Dict[str, torch.Tensor]
LOSS_CHUNK = 512
ALIGN_WEIGHT = 0.01
ALIGN_TAU = 0.2


def sub(tree: Tree, prefix: str) -> Tree:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in tree.items() if k.startswith(prefix + "/")}


def layout(cfg):
    """{path: (shape, float32)} of the Zamba2 LM: the embedding, the final
    norm, the head, the Mamba2 blocks stacked (groups, attn_every, ...) and
    the shared attention + SwiGLU block."""
    d, V, s = cfg["d_model"], cfg["vocab_size"], cfg["ssm"]
    hd = cfg["head_dim"] or d // cfg["num_heads"]
    G, A = cfg["num_layers"] // cfg["attn_every"], cfg["attn_every"]
    di = s["expand"] * d
    H, N, C = di // s["head_dim"], s["state_dim"], di + 2 * s["state_dim"]
    mamba = {"D": (H,), "a_log": (H,), "conv_b": (C,),
             "conv_w": (s["conv_width"], C), "dt_bias": (H,),
             "norm/scale": (di,), "w_in": (d, 2 * di + 2 * N + H),
             "w_out": (di, d)}
    shapes = {"embed": (V, d), "final_ln/scale": (d,), "lm_head": (d, V),
              "blocks/ln/scale": (G, A, d)}
    shapes.update({f"blocks/mamba/{k}": (G, A) + v for k, v in mamba.items()})
    shapes.update({"shared_attn/attn/wk": (d, cfg["num_kv_heads"] * hd),
                   "shared_attn/attn/wo": (cfg["num_heads"] * hd, d),
                   "shared_attn/attn/wq": (d, cfg["num_heads"] * hd),
                   "shared_attn/attn/wv": (d, cfg["num_kv_heads"] * hd),
                   "shared_attn/ln1/scale": (d,),
                   "shared_attn/ln2/scale": (d,),
                   "shared_attn/mlp/w_down": (cfg["d_ff"], d),
                   "shared_attn/mlp/w_gate": (d, cfg["d_ff"]),
                   "shared_attn/mlp/w_up": (d, cfg["d_ff"])})
    return {k: (v, torch.float32) for k, v in shapes.items()}


def ssd(xh, dt, a, Bm, Cm, chunk: int):
    """The chunked SSD scan from a zero state, fp32. xh (B, S, H, P); dt,
    a = dt * A (B, S, H); Bm, Cm (B, S, N). Per chunk with cum =
    cumsum(a): y_i = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j +
    exp(cum_i) C_i.h, and h <- exp(cum_last) h + sum_j exp(cum_last -
    cum_j) dt_j x_j B_j^T."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    x = xh.reshape(Bsz, nc, chunk, H, P).permute(1, 0, 3, 2, 4)
    dts = dt.reshape(Bsz, nc, chunk, H).permute(1, 0, 3, 2)
    cums = torch.cumsum(a.reshape(Bsz, nc, chunk, H).permute(1, 0, 3, 2), -1)
    Bc = Bm.reshape(Bsz, nc, chunk, N).transpose(0, 1)
    Cc = Cm.reshape(Bsz, nc, chunk, N).transpose(0, 1)
    h = xh.new_zeros((Bsz, H, P, N))
    i = torch.arange(chunk, device=xh.device)
    causal = i[:, None] >= i[None, :]
    ys = []
    for c in range(nc):
        cum, dtc = cums[c], dts[c]
        L = torch.exp((cum[..., :, None] - cum[..., None, :])
                      .masked_fill(~causal, float("-inf")))
        M = (Cc[c] @ Bc[c].transpose(-1, -2))[:, None] * L * dtc[..., None, :]
        y = M @ x[c] + (Cc[c][:, None] @ h.transpose(-1, -2)) \
            * torch.exp(cum)[..., None]
        w = torch.exp(cum[..., -1:] - cum) * dtc
        h = h * torch.exp(cum[..., -1])[..., None, None] \
            + (x[c] * w[..., None]).transpose(-1, -2) @ Bc[c][:, None]
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1)


def mamba2(p: Tree, x, cfg, num: Numerics):
    s = cfg["ssm"]
    B, S, _ = x.shape
    di = s["expand"] * cfg["d_model"]
    H, N, K = di // s["head_dim"], s["state_dim"], s["conv_width"]
    proj = num.mm(x, p["w_in"]).to(torch.float32)
    z, xr, Bm, Cm, dt = torch.split(proj, [di, di, N, N, H], dim=-1)
    conv_in = torch.cat([xr, Bm, Cm], dim=-1)
    xp = F.pad(conv_in, (0, 0, K - 1, 0))
    conv = torch.zeros_like(conv_in)
    for k in range(K):
        conv = conv + xp[:, k:k + S] * p["conv_w"][k]
    xr, Bm, Cm = torch.split(F.silu(conv + p["conv_b"]), [di, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    xh = xr.reshape(B, S, H, s["head_dim"])
    y = ssd(xh, dt, dt * A, Bm, Cm, min(s["chunk_size"], S))
    y = y + xh * p["D"][None, None, :, None]
    y = rmsnorm(y.reshape(B, S, di) * F.silu(z), p["norm/scale"],
                cfg["norm_eps"])
    return num.mm(y, p["w_out"]).to(x.dtype)


def hidden(params: Tree, tokens, cfg, num: Numerics, *, sub_layers: int,
           active_from: int):
    """(B, S) tokens -> the final-normed hidden states (B, S, d); the
    groups below ``active_from`` (the shared block's uses after them too)
    under ``torch.no_grad()``."""
    x = params["embed"][tokens] * math.sqrt(cfg["d_model"])
    blocks, shared = sub(params, "blocks"), sub(params, "shared_attn")
    eps = cfg["norm_eps"]

    def group(x, g):
        for i in range(cfg["attn_every"]):
            b = {k: t[g, i] for k, t in blocks.items()}
            x = x + mamba2(sub(b, "mamba"), rmsnorm(x, b["ln/scale"], eps),
                           cfg, num)
        x = x + self_attention(sub(shared, "attn"), rmsnorm(
            x, shared["ln1/scale"], eps), cfg, num, causal=True)
        return x + mlp(sub(shared, "mlp"), rmsnorm(x, shared["ln2/scale"], eps),
                       cfg["act"], num)

    act = max(0, min(active_from, sub_layers))
    with torch.no_grad():
        for g in range(act):
            x = group(x, g)
    for g in range(act, sub_layers):
        x = group(x, g)
    return rmsnorm(x, params["final_ln/scale"], eps)


def xent(params: Tree, h, labels, num: Numerics):
    """Mean next-token cross-entropy, the logits taken 512 positions at a
    time."""
    S = h.shape[1]
    c = LOSS_CHUNK if S % LOSS_CHUNK == 0 else S
    tot = h.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, c):
        logits = num.mm(h[:, s0:s0 + c], params["lm_head"]).to(torch.float32)
        gold = torch.take_along_dim(logits, labels[:, s0:s0 + c, None],
                                    dim=-1)[..., 0]
        tot = tot + torch.sum(torch.logsumexp(logits, dim=-1) - gold)
    return tot / labels.numel()


def lm_ssl_loss(params, tokens, labels, cfg, num, *, sub_layers,
                active_from, global_params):
    h = hidden(params, tokens, cfg, num, sub_layers=sub_layers,
               active_from=active_from)
    loss = xent(params, h, labels, num)
    if global_params is None:
        return loss
    with torch.no_grad():
        hg = hidden(global_params, tokens, cfg, num, sub_layers=sub_layers,
                    active_from=0)
    return loss + ALIGN_WEIGHT * info_nce(
        torch.mean(h.to(torch.float32), dim=1),
        torch.mean(hg.to(torch.float32), dim=1), ALIGN_TAU)


def follow(inputs, plan_for, rounds: int, cfg, train, fl, *, num: Numerics,
           params: Tree, fault=None, grads=None):
    """``rounds`` FL rounds from ``params``; returns [(the clients' last
    losses, the FedAvg aggregate, the params after the round: the
    aggregate)]. ``inputs`` holds ``tokens``,
    ``labels`` and the clients' index tensors ``shards``. ``fault`` as in
    ``reference.vit.follow``; ``grads``, a dict, gets the leaves' gradient
    norms at the first local step (``local``)."""
    grads = {} if grads is None else grads
    grads.update(local={})
    opt = AdamW(train["b1"], train["b2"], train["eps"], train["weight_decay"])
    B = train["batch_size"]
    base_lr = train["base_lr"] * B / 256.0
    shards = inputs["shards"]
    w = client_weights([len(ix) for ix in shards])
    out = []
    for r in range(rounds):
        p = plan_for(r)
        if p.new_stage and fl["weight_transfer"]:
            params = transfer(params, p.stage)
        lr = learning_rate(r, fl["rounds"], base_lr)
        mask = update_mask(params, p.sub_layers, p.active_from)
        trees, losses = [], []
        for ix in shards:
            q, ost = params, opt.init(params)
            nb = max(1, len(ix) // B)
            for b in range(nb * fl["local_epochs"]):
                sel = ix[(b * B) % max(1, len(ix) - B):][:B]
                if fault == "half":
                    sel = sel[:B // 2]
                leaves = {k: v.detach().requires_grad_() for k, v in q.items()}
                loss = lm_ssl_loss(leaves, inputs["tokens"][sel],
                                   inputs["labels"][sel], cfg, num,
                                   sub_layers=p.sub_layers,
                                   active_from=p.active_from,
                                   global_params=params if p.align else None)
                gs = torch.autograd.grad(loss, list(leaves.values()),
                                         allow_unused=True)
                g = {k: torch.zeros_like(v) if t is None else t
                     for (k, v), t in zip(leaves.items(), gs)}
                if not grads["local"]:
                    grads["local"].update(
                        {k: float(torch.linalg.vector_norm(t))
                         for k, t in g.items()})
                q, ost = opt.update(g, ost, q, lr, mask)
            losses.append(float(loss.detach()))
            trees.append(q)
        if fault == "upload":
            trees[0] = {k: 2 * v - params[k] for k, v in trees[0].items()}
        agg = trees[0] if fault == "noavg" else fedavg(trees, w)
        if fault == "answer":
            k = min(agg)
            agg = {**agg, k: 2 * agg[k] - params[k]}
        params = agg
        del trees
        out.append((losses, params, params))
    return out
