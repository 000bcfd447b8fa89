"""Model FLOPs and kernel work of one round of an LM FL mix on a Zamba2
configuration, from its widths and the mix (products and the SSD scan's
operations; elementwise work, norms and softmaxes are left out).

Every forward pass counts (the online model with its frozen groups, the
alignment's global model); each trained group's backward counts twice its
forward, and the frozen LM head once (the gradient passes through it, its
weight takes none), with no recomputation.
"""
from __future__ import annotations

from portbench.counts import kernels
from portbench.counts.peaks import BF16_FLOPS, SSD_FLOPS, least_seconds


def _dims(m):
    s = m["ssm"]
    di = s["expand"] * m["d_model"]
    return s, di, di // s["head_dim"]


def mamba_block(m, B: int, S: int) -> int:
    """One Mamba2 block over B sequences of S tokens."""
    s, di, H = _dims(m)
    d, N = m["d_model"], s["state_dim"]
    proj = 2 * B * S * d * (2 * di + 2 * N + H) + 2 * B * S * di * d
    conv = 2 * B * S * s["conv_width"] * (di + 2 * N)
    scan, _ = kernels.ssd_scan_fwd(B, S, H, s["head_dim"], N,
                                   min(s["chunk_size"], S))
    return proj + conv + scan


def shared_block(m, B: int, S: int) -> int:
    """The shared attention + SwiGLU block over B sequences of S tokens."""
    d, H = m["d_model"], m["num_heads"]
    hd = m["head_dim"] or d // H
    att, _ = kernels.attention_fwd(B, S, S, H, hd, hd, True)
    return 2 * B * S * d * H * hd * 4 + att + 2 * B * S * d * m["d_ff"] * 3


def round_work(cfg, mix, plan) -> dict:
    m = cfg["model"]
    B, S = cfg["train"]["batch_size"], mix["seq_len"]
    C = mix["clients"]
    steps = mix["local_epochs"] * max(1, mix["seqs_per_client"] // B)
    group = m["attn_every"] * mamba_block(m, B, S) + shared_block(m, B, S)
    head = 2 * B * S * m["d_model"] * m["vocab_size"]
    sub, act = plan.sub_layers, plan.active_from
    fwd = sub * group + head + (sub * group if plan.align else 0)
    bwd = 2 * (sub - act) * group + (2 if act == 0 else 1) * head
    flops = C * steps * (fwd + bwd)
    passes = 2 if plan.align else 1
    calls = C * steps * passes * sub
    s, _, H = _dims(m)
    hd = m["head_dim"] or m["d_model"] // m["num_heads"]
    fa, ba = kernels.attention_fwd(B, S, S, m["num_heads"], hd, hd, True)
    fs, bs = kernels.ssd_scan_fwd(B, S, H, s["head_dim"], s["state_dim"],
                                  min(s["chunk_size"], S))
    n_ssd = calls * m["attn_every"]
    return {"model_flops": flops, "kernels": {
        "attention": {"calls": calls, "flops": calls * fa,
                      "bytes": calls * ba,
                      "least_s": calls * least_seconds(fa, ba, BF16_FLOPS)},
        "ssd_scan": {"calls": n_ssd, "flops": n_ssd * fs,
                     "bytes": n_ssd * bs,
                     "least_s": n_ssd * least_seconds(fs, bs, SSD_FLOPS)}}}
