"""Plain reference of the Zamba2 LM cells: Zamba2 at its published layout
(``references/zamba2_published.py``, the repository's plain float32
reference, copied here for the harness), trained layer-wise over FL rounds
on next-token cross-entropy plus the Eq. 3 alignment of its mean-pooled
hidden states with the downloaded global model's (the port's
``run_lm_fedssl`` on its ``zamba2`` topology).

Differences from the repository's reference, for the harness: the
products go through ``Numerics.mm`` (the configuration's compute dtype,
and the fp8 control); the scan is the chunked SSD form in float32 (the
exact sum, grouped as the kernel groups it) rather than one position at a
time, which at 4096 positions would take minutes a layer; and a client
keeps copies and AdamW state of the leaves its stage trains only, so that
the reference of a 2.2-billion-parameter cut fits on the card beside
nothing else. Leaves that a stage freezes are the same tensors in every
tree: the masked update leaves them as they are.

A round: each client in turn takes its local steps from the server's
model, one AdamW step of the stage's leaves per batch of its shard; FedAvg
over their trees. Nothing here imports the program.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.common import (AdamW, Numerics, client_weights,
                                        info_nce, learning_rate)

Tree = Dict[str, torch.Tensor]
LOSS_CHUNK = 512
ALIGN_WEIGHT = 0.01
ALIGN_TAU = 0.2


def sub(tree: Tree, prefix: str) -> Tree:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in tree.items() if k.startswith(prefix + "/")}


def _dims(cfg):
    s = cfg["ssm"]
    di = s["expand"] * cfg["d_model"]
    return s, di, di // s["head_dim"], s["n_groups"] * s["state_dim"]


def uses(cfg):
    """The hybrid layers the config builds, in order."""
    return [l for l in cfg["hybrid_layer_ids"] if l < cfg["num_layers"]]


def num_stages(cfg) -> int:
    return -(-cfg["num_layers"] // cfg["stage_layers"])


def layout(cfg):
    """{path: (shape, float32)}: the tied embedding, the final norm, each
    Mamba2 layer (``layers/<l>``), each use's LoRA and projection
    (``hybrid/<i>``), each shared block (``mem_blocks/<b>``)."""
    d, V, f, r = (cfg["d_model"], cfg["vocab_size"], cfg["d_ff"],
                  cfg["adapter_rank"])
    s, di, H, GN = _dims(cfg)
    conv = di + 2 * GN
    w = cfg["num_heads"] * cfg["head_dim"]
    out = {"embed": (V, d), "final_ln/scale": (d,)}
    for l in range(cfg["num_layers"]):
        out.update({f"layers/{l}/{k}": v for k, v in {
            "ln/scale": (d,), "mamba/D": (H,), "mamba/a_log": (H,),
            "mamba/conv_b": (conv,), "mamba/conv_w": (s["conv_width"], conv),
            "mamba/dt_bias": (H,), "mamba/norm/scale": (di,),
            "mamba/w_in": (d, di + conv + H), "mamba/w_out": (di, d)}.items()})
    for i in range(len(uses(cfg))):
        out.update({f"hybrid/{i}/adapter_a": (d, r),
                    f"hybrid/{i}/adapter_b": (r, 2 * f),
                    f"hybrid/{i}/linear": (d, d)})
    for b in range(cfg["num_mem_blocks"]):
        out.update({f"mem_blocks/{b}/{k}": v for k, v in {
            "ln_in/scale": (2 * d,), "attn/wq": (2 * d, w),
            "attn/wk": (2 * d, w), "attn/wv": (2 * d, w), "attn/wo": (w, d),
            "ln_ff/scale": (d,), "mlp/w_gate": (d, f), "mlp/w_up": (d, f),
            "mlp/w_down": (f, d)}.items()})
    return {k: (v, torch.float32) for k, v in sorted(out.items())}


def rmsnorm(x, scale, eps):
    x = x.to(torch.float32)
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, theta):
    """x (B, S, H, hd) float32: split-half rotary embedding."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p: Tree, h, cfg, num: Numerics):
    """Causal attention over the joined input h (B, S, 2 d): products in
    the compute dtype, logits, softmax and p.v in float32."""
    B, S, _ = h.shape
    H, hd = cfg["num_heads"], cfg["head_dim"]
    q = rope(num.mm(h, p["wq"]).float().reshape(B, S, H, hd),
             cfg["rope_theta"]).transpose(1, 2)
    k = rope(num.mm(h, p["wk"]).float().reshape(B, S, H, hd),
             cfg["rope_theta"]).transpose(1, 2)
    v = num.mm(h, p["wv"]).float().reshape(B, S, H, hd).transpose(1, 2)
    lg = (q @ k.transpose(-1, -2)) * (hd / 2) ** -0.5
    keep = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    prob = torch.softmax(lg.masked_fill(~keep, float("-inf")), dim=-1)
    out = (prob @ v).transpose(1, 2).reshape(B, S, H * hd)
    return num.mm(out, p["wo"]).float()


def shared_block(p: Tree, use: Tree, x, e, cfg, num: Numerics):
    """T = W_i MLP_{b,i}(RMSNorm_ff(Attn_b(RMSNorm_in([x, e]))))."""
    eps, f = cfg["norm_eps"], cfg["d_ff"]
    a = attention(sub(p, "attn"), rmsnorm(torch.cat([x, e], dim=-1),
                                          p["ln_in/scale"], eps), cfg, num)
    h = rmsnorm(a, p["ln_ff/scale"], eps)
    lora = num.mm(num.mm(h, use["adapter_a"]), use["adapter_b"]).float()
    g = num.mm(h, p["mlp/w_gate"]).float() + lora[..., :f]
    u = num.mm(h, p["mlp/w_up"]).float() + lora[..., f:]
    y = num.mm(F.gelu(g) * u, p["mlp/w_down"])
    return num.mm(y, use["linear"]).float()


def ssd(xh, dt, a, Bm, Cm, chunk: int):
    """The chunked SSD scan from a zero state, float32, G groups. xh (B,
    S, H, P); dt, a = dt * A (B, S, H); Bm, Cm (B, S, G, N), head h reading
    group h // (H / G). Per chunk with cum = cumsum(a): y_i = sum_{j<=i}
    (C_i.B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i.h, and h <-
    exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T."""
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[-2:]
    rep, nc = H // G, S // chunk
    x = xh.reshape(Bsz, nc, chunk, H, P).permute(1, 0, 3, 2, 4)
    dts = dt.reshape(Bsz, nc, chunk, H).permute(1, 0, 3, 2)
    cums = torch.cumsum(a.reshape(Bsz, nc, chunk, H).permute(1, 0, 3, 2), -1)
    Bc = Bm.reshape(Bsz, nc, chunk, G, N).permute(1, 0, 3, 2, 4)
    Cc = Cm.reshape(Bsz, nc, chunk, G, N).permute(1, 0, 3, 2, 4)
    h = xh.new_zeros((Bsz, H, P, N))
    i = torch.arange(chunk, device=xh.device)
    causal = i[:, None] >= i[None, :]
    ys = []
    for c in range(nc):
        cum, dtc = cums[c], dts[c]
        L = torch.exp((cum[..., :, None] - cum[..., None, :])
                      .masked_fill(~causal, float("-inf")))
        CB = (Cc[c] @ Bc[c].transpose(-1, -2)).repeat_interleave(rep, dim=1)
        y = (CB * L * dtc[..., None, :]) @ x[c] \
            + (Cc[c].repeat_interleave(rep, dim=1) @ h.transpose(-1, -2)) \
            * torch.exp(cum)[..., None]
        w = torch.exp(cum[..., -1:] - cum) * dtc
        h = h * torch.exp(cum[..., -1])[..., None, None] \
            + (x[c] * w[..., None]).transpose(-1, -2) \
            @ Bc[c].repeat_interleave(rep, dim=1)
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1)


def mamba2(p: Tree, u, cfg, num: Numerics):
    """The Mamba2 mixer on its normed input u (B, S, d)."""
    s, di, H, GN = _dims(cfg)
    Bsz, S, _ = u.shape
    G, N, K = s["n_groups"], s["state_dim"], s["conv_width"]
    z, xbc, dt = torch.split(num.mm(u, p["w_in"]).float(),
                             [di, di + 2 * GN, H], dim=-1)
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    conv = torch.zeros_like(xbc)
    for k in range(K):
        conv = conv + xp[:, k:k + S] * p["conv_w"][k]
    xr, Bm, Cm = torch.split(F.silu(conv + p["conv_b"]), [di, GN, GN], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    xh = xr.reshape(Bsz, S, H, s["head_dim"])
    y = ssd(xh, dt, dt * -torch.exp(p["a_log"]), Bm.reshape(Bsz, S, G, N),
            Cm.reshape(Bsz, S, G, N), min(s["chunk_size"], S))
    y = (y + xh * p["D"][:, None]).reshape(Bsz, S, di) * F.silu(z)
    y = rmsnorm(y.reshape(Bsz, S, G, di // G),
                p["norm/scale"].reshape(G, di // G), cfg["norm_eps"])
    return num.mm(y.reshape(Bsz, S, di), p["w_out"]).float()


def hidden(params: Tree, tokens, cfg, num: Numerics, *, sub_stages: int,
           active_from: int):
    """(B, S) tokens -> the final-normed stream (B, S, d) over the layers
    of the first ``sub_stages`` stages, those below ``active_from`` (with
    their shared blocks' uses) under ``torch.no_grad()``."""
    per, eps = cfg["stage_layers"], cfg["norm_eps"]
    use_of = {l: i for i, l in enumerate(uses(cfg))}
    x = e = params["embed"][tokens]
    for l in range(min(cfg["num_layers"], sub_stages * per)):
        with torch.no_grad() if l // per < active_from else \
                contextlib.nullcontext():
            p = sub(params, f"layers/{l}")
            t = 0.0
            if l in use_of:
                i = use_of[l]
                t = shared_block(
                    sub(params, f"mem_blocks/{i % cfg['num_mem_blocks']}"),
                    sub(params, f"hybrid/{i}"), x, e, cfg, num)
            x = x + mamba2(sub(p, "mamba"), rmsnorm(x + t, p["ln/scale"], eps),
                           cfg, num)
    return rmsnorm(x, params["final_ln/scale"], eps)


def xent(params: Tree, h, labels, num: Numerics):
    """Mean next-token cross-entropy over the tied embedding, the logits
    taken 512 positions at a time."""
    S = h.shape[1]
    c = LOSS_CHUNK if S % LOSS_CHUNK == 0 else S
    tot = h.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, c):
        lg = num.mm(h[:, s0:s0 + c], params["embed"].T).float()
        gold = torch.take_along_dim(lg, labels[:, s0:s0 + c, None],
                                    dim=-1)[..., 0]
        tot = tot + torch.sum(torch.logsumexp(lg, dim=-1) - gold)
    return tot / labels.numel()


def lm_ssl_loss(params, tokens, labels, cfg, num, *, sub_stages,
                active_from, global_params):
    h = hidden(params, tokens, cfg, num, sub_stages=sub_stages,
               active_from=active_from)
    loss = xent(params, h, labels, num)
    if global_params is None:
        return loss
    with torch.no_grad():
        hg = hidden(global_params, tokens, cfg, num, sub_stages=sub_stages,
                    active_from=0)
    return loss + ALIGN_WEIGHT * info_nce(torch.mean(h, dim=1),
                                          torch.mean(hg, dim=1), ALIGN_TAU)


def stage_leaves(cfg, params: Tree, sub_stages: int,
                 active_from: int) -> list:
    """The leaves the stage trains: the final norm, the embedding when
    nothing is frozen, the trained stages' Mamba2 layers, and the uses and
    shared blocks that those stages' hybrid layers hold."""
    per = cfg["stage_layers"]

    def trained(l):
        return active_from <= l // per < sub_stages
    use_layers = uses(cfg)
    out = []
    for k in params:
        kind, _, rest = k.partition("/")
        row = rest.split("/")[0]
        if kind == "layers":
            ok = trained(int(row))
        elif kind == "hybrid":
            ok = trained(use_layers[int(row)])
        elif kind == "mem_blocks":
            ok = any(trained(l) for i, l in enumerate(use_layers)
                     if i % cfg["num_mem_blocks"] == int(row))
        else:
            ok = k != "embed" or active_from == 0
        if ok:
            out.append(k)
    return out


def transfer(cfg, tree: Tree, stage: int) -> Tree:
    """Weight transfer at ``stage``'s start: each Mamba2 layer of stage - 1
    copied into the layer at its place in ``stage``."""
    if stage < 2:
        return tree
    per, out = cfg["stage_layers"], dict(tree)
    for l in range((stage - 1) * per, min(stage * per, cfg["num_layers"])):
        src = f"layers/{l - per}/"
        for k in tree:
            if k.startswith(src):
                out[f"layers/{l}/" + k[len(src):]] = tree[k].clone()
    return out


def follow(inputs, plan_for, rounds: int, cfg, train, fl, *, num: Numerics,
           params: Tree, fault=None, grads=None):
    """``rounds`` FL rounds from ``params``; returns [(the clients' last
    losses, the FedAvg aggregate, the params after the round: the
    aggregate)]. ``inputs`` holds ``tokens``, ``labels`` and the clients'
    index tensors ``shards``. ``fault`` as in ``reference.vit.follow``
    (``half``: each loss over half the batch's sequences, or over the first
    half of the positions of a batch of one); ``grads``, a dict, gets the
    trained leaves' gradient norms at the first local step (``local``)."""
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
            params = transfer(cfg, params, p.stage)
        lr = learning_rate(r, fl["rounds"], base_lr)
        keys = stage_leaves(cfg, params, p.sub_layers, p.active_from)
        ones = {k: torch.ones((), device=params[k].device) for k in keys}
        agg, losses = None, []
        for c, ix in enumerate(shards):
            q = {k: params[k] for k in keys}
            ost = opt.init(q)
            nb = max(1, len(ix) // B)
            for b in range(nb * fl["local_epochs"]):
                sel = ix[(b * B) % max(1, len(ix) - B):][:B]
                tok, lab = inputs["tokens"][sel], inputs["labels"][sel]
                if fault == "half":
                    if B > 1:
                        tok, lab = tok[:B // 2], lab[:B // 2]
                    else:
                        tok, lab = (t[:, :t.shape[1] // 2] for t in (tok, lab))
                leaves = {k: v.detach().requires_grad_() for k, v in q.items()}
                loss = lm_ssl_loss({**params, **leaves}, tok, lab, cfg, num,
                                   sub_stages=p.sub_layers,
                                   active_from=p.active_from,
                                   global_params=params if p.align else None)
                gs = torch.autograd.grad(loss, list(leaves.values()),
                                         allow_unused=True)
                g = {k: torch.zeros_like(v) if t is None else t
                     for (k, v), t in zip(leaves.items(), gs)}
                del leaves, gs
                if not grads["local"]:
                    grads["local"].update(
                        {k: float(torch.linalg.vector_norm(t))
                         for k, t in g.items()})
                q, ost = opt.update(g, ost, q, lr, ones)
                del g
            losses.append(float(loss.detach()))
            del ost, loss
            if fault == "upload" and c == 0:
                q = {k: 2 * v - params[k] for k, v in q.items()}
            if fault == "noavg":
                agg = q if c == 0 else agg
                continue
            # FedAvg over the trained leaves, client by client; the frozen
            # leaves are every client's own, unchanged
            agg = {k: w[c] * v for k, v in q.items()} if agg is None else \
                {k: agg[k] + w[c] * v for k, v in q.items()}
            del q
        if fault == "answer":
            k = min(agg)
            agg = {**agg, k: 2 * agg[k] - params[k]}
        params = {**params, **agg}
        del agg
        out.append((losses, params, params))
    return out
