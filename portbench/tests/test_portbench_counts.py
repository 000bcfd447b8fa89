"""The benchmark's operation and byte counts against hand counts at small
shapes, and its model FLOPs against a FLOP counter run over the plain
reference's own forward passes."""
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import kernels, lm as lm_counts, vit as vit_counts
from portbench.counts.peaks import HBM_BYTES, least_seconds
from portbench.reference import lm as ref_lm, vit as ref_vit
from portbench.reference.common import Numerics, round_plan
from portbench.lib.init import init_tree
from portbench.tests import tiny


def test_attention_by_hand():
    # B 1, S 2, T 3, H 1, hd = dv = 4: q.k^T 2*3*4 MACs, p.v 2*3*4 MACs
    f, b = kernels.attention_fwd(1, 2, 3, 1, 4, 4, False)
    assert f == 2 * (2 * 3 * 4 + 2 * 3 * 4)
    assert b == 2 * (2 * 4 + 3 * 4 + 3 * 4 + 2 * 4)
    assert kernels.attention_fwd(1, 2, 3, 1, 4, 4, True)[0] == f // 2


def test_ssd_by_hand():
    """Multiply-adds of the chunked scan counted one by one."""
    B, S, H, P, N, Q = 2, 8, 3, 2, 4, 4
    macs = 0
    for _ in range(B):
        for c in range(S // Q):
            for i in range(Q):
                for j in range(i + 1):
                    macs += N                       # C_i . B_j
            for _ in range(H):
                for i in range(Q):
                    for j in range(i + 1):
                        macs += P                   # M_ij x_j
                macs += 2 * Q * N * P               # state in, state out
    f, b = kernels.ssd_scan_fwd(B, S, H, P, N, Q)
    assert f == 2 * macs
    assert b == 4 * (2 * B * S * H * P + 2 * B * S * H + 2 * B * S * N
                     + B * H * P * N)


def test_least_seconds():
    assert least_seconds(1.0, HBM_BYTES, 1e30) == 1.0
    assert least_seconds(2e12, 0.0, 1e12) == 2.0


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_vit_forward_flops():
    """One view through the encoder and both heads, as the counts have
    it (the reference's attention is products, which the counter sees)."""
    cfg = {**tiny.VIT, "compute_dtype": "float32"}
    p = init_tree(ref_vit.layout(cfg, tiny.SSL), 0, "cpu")
    x = torch.rand(4, 32, 32, 3)
    num = Numerics("float32")

    def fwd():
        z = ref_vit.encoder(ref_vit.sub(p, "enc"), x, cfg, num, 2, 0)
        ref_vit.head(ref_vit.sub(p, "pred"),
                     ref_vit.head(ref_vit.sub(p, "proj"), z))
    S = 65
    patch = 2 * (S - 1) * 48 * cfg["d_model"]
    proj, pred = vit_counts.heads(tiny.SSL, cfg["d_model"])
    want = 4 * (patch + 2 * vit_counts.block(cfg, S) + proj + pred)
    assert _counted(fwd) == want


def test_lm_forward_flops():
    """The LM's forward with its head: the counts' matmuls, attention and
    scan (the scan's C.B^T and masked products over the causal half only:
    the reference computes whole chunks, Q (Q + 1) / 2 of Q^2)."""
    cfg = {**tiny.LM, "compute_dtype": "float32"}
    p = init_tree(ref_lm.layout(cfg), 0, "cpu")
    B, S = 2, 16
    tok = torch.randint(0, cfg["vocab_size"], (B, S))
    num = Numerics("float32")

    def fwd():
        h = ref_lm.hidden(p, tok, cfg, num, sub_layers=2, active_from=0)
        ref_lm.xent(p, h, tok, num)
    got = _counted(fwd)
    s = cfg["ssm"]
    di = s["expand"] * cfg["d_model"]
    H, Q = di // s["head_dim"], s["chunk_size"]
    scan_f, _ = kernels.ssd_scan_fwd(B, S, H, s["head_dim"], s["state_dim"],
                                     Q)
    # whole chunks in the reference: C.B^T and M.x over Q^2, not Q (Q+1)/2
    nc = S // Q
    full = B * nc * 2 * Q * Q * s["state_dim"] \
        + B * H * nc * (2 * Q * Q * s["head_dim"]
                        + 4 * Q * s["state_dim"] * s["head_dim"])
    conv = 2 * B * S * s["conv_width"] * (di + 2 * s["state_dim"])
    att, _ = kernels.attention_fwd(B, S, S, cfg["num_heads"],
                                   cfg["head_dim"], cfg["head_dim"], True)
    group = cfg["attn_every"] * (lm_counts.mamba_block(cfg, B, S) - scan_f
                                 - conv + full) \
        + lm_counts.shared_block(cfg, B, S) + att   # masked half counted
    head = 2 * B * S * cfg["d_model"] * cfg["vocab_size"]
    assert got == 2 * group + head


def test_round_work_matches_steps():
    mix = tiny.MIXES["tiny-lm"]
    cfg = {"model": tiny.LM, "train": {**tiny.TRAIN, "batch_size": 2}}
    plan = round_plan("lw_fedssl", 2, 0, 2)
    w = lm_counts.round_work(cfg, mix, plan)
    steps = mix["clients"] * mix["seqs_per_client"] // 2
    assert w["kernels"]["attention"]["calls"] == steps * 2 * 2
    assert w["kernels"]["ssd_scan"]["calls"] == steps * 2 * 2 * 2
    assert w["model_flops"] > 0
    vmix = tiny.MIXES["tiny-vit"]
    vw = vit_counts.round_work({"model": tiny.VIT, "ssl": tiny.SSL,
                                "train": tiny.TRAIN}, vmix,
                               round_plan("lw_fedssl", 2, 0, 2))
    local = vmix["local_epochs"] * vmix["images_per_client"] // 8
    cal = vmix["server_epochs"] * (16 // 8)
    assert vw["kernels"]["attention"]["calls"] == local * 2 * 3 * 2 \
        + cal * 2 * 2 * 2
    assert math.isfinite(vw["model_flops"])
