"""Model FLOPs and kernel work of one round of an LM FL mix on a Zamba2
configuration at its published layout (``reference/zamba2.py``), from its
widths and the mix: products, the SSD scan's operations and attention's
(elementwise work, norms and softmaxes are left out).

The grouped scan and the 224-wide attention are counted here, not through
``counts/kernels.py``: C.B^T once per group and chunk, and the joined
(2 d wide) input of the shared block's q, k and v.

Every forward pass counts (the online model with its frozen stages, the
alignment's global model, which computes no logits); each trained stage's
backward counts twice its forward, and the tied LM head's backward once
while the embedding is frozen (the gradient passes through it, its weight
takes none), with no recomputation.
"""
from __future__ import annotations

from portbench.counts.peaks import BF16_FLOPS, SSD_FLOPS, least_seconds


def _dims(m):
    s = m["ssm"]
    di = s["expand"] * m["d_model"]
    return s, di, di // s["head_dim"], s["n_groups"]


def ssd_scan(B: int, S: int, H: int, P: int, N: int, G: int, chunk: int):
    """(flops, bytes) of the chunked SSD scan with G groups of B and C:
    C.B^T over each chunk's causal half (Q (Q + 1) / 2 entries, 2 N
    operations each) once per sequence, group and chunk; per head and
    chunk the masked products with x over the causal half and the state's
    way in and out (4 Q N P). fp32 xh, dt, dt A, B, C read; y and the final
    state written."""
    Q = chunk
    nc = S // Q
    flops = B * G * nc * Q * (Q + 1) * N \
        + B * H * nc * (Q * (Q + 1) * P + 4 * Q * N * P)
    nbytes = 4 * (2 * B * S * H * P + 2 * B * S * H + 2 * B * S * G * N
                  + B * H * P * N)
    return flops, nbytes


def attention(B: int, S: int, H: int, hd: int):
    """(flops, bytes) of causal attention over (B, S, H, hd) bf16 q, k, v:
    q.k^T and p.v over the causal half; q, k, v read, o written once."""
    return 2 * B * H * S * S * 2 * hd // 2, 2 * 4 * B * S * H * hd


def mamba_layer(m, B: int, S: int) -> int:
    """One Mamba2 layer over B sequences of S tokens."""
    s, di, H, G = _dims(m)
    d, N = m["d_model"], s["state_dim"]
    conv = di + 2 * G * N
    proj = 2 * B * S * d * (di + conv + H) + 2 * B * S * di * d
    scan, _ = ssd_scan(B, S, H, s["head_dim"], N, G, min(s["chunk_size"], S))
    return proj + 2 * B * S * s["conv_width"] * conv + scan


def shared_use(m, B: int, S: int) -> int:
    """One use of a shared block: q, k, v from the joined 2 d input, o,
    attention, the GeGLU MLP with the use's LoRA on its gate-up product,
    and the use's d x d projection."""
    d, f, r = m["d_model"], m["d_ff"], m["adapter_rank"]
    w = m["num_heads"] * m["head_dim"]
    att, _ = attention(B, S, m["num_heads"], m["head_dim"])
    return (2 * B * S * (3 * 2 * d * w + w * d) + att
            + 2 * B * S * 3 * d * f + 2 * B * S * r * (d + 2 * f)
            + 2 * B * S * d * d)


def round_work(cfg, mix, plan) -> dict:
    m = cfg["model"]
    B, S = cfg["train"]["batch_size"], mix["seq_len"]
    C = mix["clients"]
    steps = mix["local_epochs"] * max(1, mix["seqs_per_client"] // B)
    per = m["stage_layers"]
    built = min(m["num_layers"], plan.sub_layers * per)
    first = min(built, plan.active_from * per)
    uses = [l for l in m["hybrid_layer_ids"] if l < built]

    def layers(lo, hi):
        return (hi - lo) * mamba_layer(m, B, S) + sum(
            shared_use(m, B, S) for l in uses if lo <= l < hi)
    head = 2 * B * S * m["d_model"] * m["vocab_size"]
    passes = 2 if plan.align else 1
    fwd = passes * layers(0, built) + head
    bwd = 2 * layers(first, built) + (2 if plan.active_from == 0 else 1) * head
    s, _, H, G = _dims(m)
    fa, ba = attention(B, S, m["num_heads"], m["head_dim"])
    fs, bs = ssd_scan(B, S, H, s["head_dim"], s["state_dim"], G,
                      min(s["chunk_size"], S))
    n_att = C * steps * passes * len(uses)
    n_ssd = C * steps * passes * built
    return {"model_flops": C * steps * (fwd + bwd), "kernels": {
        "attention": {"calls": n_att, "flops": n_att * fa,
                      "bytes": n_att * ba,
                      "least_s": n_att * least_seconds(fa, ba, BF16_FLOPS)},
        "ssd_scan": {"calls": n_ssd, "flops": n_ssd * fs,
                     "bytes": n_ssd * bs,
                     "least_s": n_ssd * least_seconds(fs, bs, SSD_FLOPS)}}}
