"""Model FLOPs and kernel work of one round of a ViT FL mix, from the
configuration's widths and the mix (products only: elementwise work,
norms and softmaxes are left out).

Every forward pass counts (the online branch with its frozen prefix, the
target branch, the alignment's global encoder) and each trained part's
backward counts twice its forward, with no recomputation. The server's
calibration steps count.
"""
from __future__ import annotations

from portbench.counts import kernels
from portbench.counts.peaks import BF16_FLOPS, least_seconds

PATCH = 4


def block(cfg, S: int) -> int:
    """One encoder block on one image of S tokens."""
    d, ff, H = cfg["d_model"], cfg["d_ff"], cfg["num_heads"]
    hd = cfg["head_dim"] or d // H
    proj = 2 * S * d * H * hd * 4                # q, k, v, o
    mlp = 2 * S * d * ff * (3 if cfg["act"] == "swiglu" else 2)
    att, _ = kernels.attention_fwd(1, S, S, H, hd, hd, False)
    return proj + mlp + att


def heads(ssl, d: int):
    """(projection head, prediction head) on one row."""
    p = (d, ssl["proj_hidden"], ssl["proj_hidden"], ssl["proj_dim"])
    q = (ssl["proj_dim"], ssl["pred_hidden"], ssl["proj_dim"])
    return (sum(2 * a * b for a, b in zip(p[:-1], p[1:])),
            sum(2 * a * b for a, b in zip(q[:-1], q[1:])))


def _step(cfg, ssl, B, sub, act, align):
    """FLOPs of one local step on a batch of B images, two views each."""
    m = cfg["model"]
    S = (32 // PATCH) ** 2 + 1
    patch = 2 * (S - 1) * PATCH * PATCH * 3 * m["d_model"]
    enc = patch + sub * block(m, S)
    proj, pred = heads(ssl, m["d_model"])
    fwd = (enc + proj + pred) + (enc + proj) + (enc if align else 0)
    trained = (sub - act) * block(m, S) + proj + pred \
        + (patch if act == 0 else 0)
    nce = 2 * 2 * B * B * ssl["proj_dim"]            # two InfoNCE terms
    if align:
        nce += 2 * 2 * B * B * m["d_model"]
    return 2 * B * (fwd + 2 * trained) + 3 * nce     # forward + its dq


def round_work(cfg, mix, plan) -> dict:
    """{"model_flops", "kernels": {name: {"calls", "flops", "bytes",
    "dtype"}}} of one round: every client's local steps and the server's
    calibration. Attention calls follow the engine: the vmap engine folds
    the clients into one call's batch."""
    m, ssl = cfg["model"], cfg["ssl"]
    B = cfg["train"]["batch_size"]
    C = mix["clients_per_round"] or mix["clients"]
    steps = mix["local_epochs"] * (mix["images_per_client"] // B)
    sub, act = plan.sub_layers, plan.active_from
    S = (32 // PATCH) ** 2 + 1
    H = m["num_heads"]
    hd = m["head_dim"] or m["d_model"] // H
    flops = C * steps * _step(cfg, ssl, B, sub, act, plan.align)
    passes = 3 if plan.align else 2                   # online, target, global
    folded = mix["engine"] == "vmap"
    batch = C * B if folded else B
    calls = steps * 2 * passes * sub * (1 if folded else C)
    rows = [(calls, batch)]
    if plan.server_calibrate:
        n_aux = int(mix["clients"] * mix["images_per_client"]
                    * mix["aux_fraction"])
        Bc = min(B, n_aux)
        csteps = mix["server_epochs"] * (n_aux // Bc)
        flops += csteps * _step(cfg, ssl, Bc, sub, 0, False)
        rows.append((csteps * 2 * 2 * sub, Bc))
    att = {"calls": 0, "flops": 0, "bytes": 0, "least_s": 0.0}
    for n, b in rows:
        f, nb = kernels.attention_fwd(b, S, S, H, hd, hd, False)
        att["calls"] += n
        att["flops"] += n * f
        att["bytes"] += n * nb
        att["least_s"] += n * least_seconds(f, nb, BF16_FLOPS)
    return {"model_flops": flops, "kernels": {"attention": att}}
