"""Zamba2 at its published layout in the port (the ``zamba2`` topology of
``models/lm.py``; the JAX package has none) against the plain reference
``references/zamba2_published.py``, and that reference against
``transformers``' ``Zamba2ForCausalLM``, all in float32 on the CPU at a
tiny size on seeded weights.

The tiny port config mirrors the benchmark's stage-3 cell: 6 layers in 3
stages of 2, hybrid layers 2, 3 and 5 using shared blocks A, B and A, so
that stage 3 trains block A through its second use while its first use
runs frozen in stage 2. Also here: the grouped SSD scan and attention at
heads of 224 on the CPU path, the stage masks, the wire's and the
accounting's leaves and bytes, weight transfer and the launcher.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import FLConfig, TrainConfig, load_arch
from repro_torch.core import ssl as ssl_mod
from repro_torch.federated import comm
from repro_torch.federated.client import grads_of, lm_step_leaves
from repro_torch.federated.driver import run_lm_fedssl
from repro_torch.federated.masks import (stage_piece, stage_update_mask,
                                         trained_leaves)
from repro_torch.federated.transport import Transport
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.optim.schedules import learning_rate, scaled_base_lr

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "zamba2_published", ROOT / "references" / "zamba2_published.py")
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)

torch.set_num_threads(2)

BASE = load_arch("zamba2-7b")
CFG = dataclasses.replace(
    BASE, num_layers=6, d_model=32, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=64, vocab_size=64, hybrid_layer_ids=(2, 3, 5), stage_layers=2,
    adapter_rank=4, compute_dtype="float32",
    ssm=dataclasses.replace(BASE.ssm, state_dim=8, head_dim=8, chunk_size=8))
SEQ = 16
# an FL round's change of a leaf, the port against the reference, over
# the reference's change (norms): fp32 gradients that agree to 2e-5 become
# AdamW steps of about lr an element, whose sign flips where a gradient is
# nought to rounding; the largest measured is 1.7e-4 (two rounds)
TOL_CHANGE = 2e-3


def ref_cfg(cfg):
    """The reference's plain-dict config of a port config."""
    s = cfg.ssm
    return {"d_model": cfg.d_model, "num_heads": cfg.num_heads,
            "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
            "vocab_size": cfg.vocab_size, "num_layers": cfg.num_layers,
            "hybrid_layer_ids": list(cfg.hybrid_layer_ids),
            "num_mem_blocks": cfg.num_mem_blocks,
            "adapter_rank": cfg.adapter_rank,
            "stage_layers": cfg.stage_layers, "norm_eps": cfg.norm_eps,
            "rope_theta": cfg.rope_theta,
            "ssm": {"state_dim": s.state_dim, "head_dim": s.head_dim,
                    "expand": s.expand, "conv_width": s.conv_width,
                    "n_groups": s.n_groups}}


RC = ref_cfg(CFG)


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = lm.init_lm(CFG, g)
    # norm scales and the LoRA away from their initial values, so that
    # they matter
    return {k: v + 0.05 * torch.randn(v.shape, generator=g)
            if k.endswith("scale") else v for k, v in params.items()}


def _tokens(seed=1, n=2, S=SEQ):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, CFG.vocab_size, (n, S), generator=g),
            torch.randint(0, CFG.vocab_size, (n, S), generator=g))


def _close(got, want, rtol, what=""):
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()) + 1e-7, (what, err)


# ---------------------------------------------------------------------------
# the reference against transformers
# ---------------------------------------------------------------------------
def test_reference_matches_transformers():
    """12 layers, hybrids at 6 and 11 (shared blocks A, B), 2 SSD groups,
    the LoRA and RoPE on: the reference's logits equal upstream's to fp32
    round-off on the same weights. One chunk (chunk_size = S): past one
    chunk transformers 4.57's plain (CPU) scan sums the inter-chunk decay
    over the target chunk instead of the source one
    (``Zamba2MambaMixer.torch_forward``: ``.sum(dim=2)``), so its states
    after the first chunk are not the recurrence's; its CUDA path is the
    mamba_ssm kernels."""
    tr = pytest.importorskip("transformers")
    L, S = 12, 16
    types = ["mamba"] * L
    types[6] = types[11] = "hybrid"
    hc = tr.Zamba2Config(
        vocab_size=64, hidden_size=32, num_hidden_layers=L,
        layers_block_type=types, mamba_d_state=8, mamba_d_conv=4,
        mamba_expand=2, mamba_ngroups=2, n_mamba_heads=8, chunk_size=S,
        intermediate_size=64, num_attention_heads=4, num_mem_blocks=2,
        use_shared_attention_adapter=False, adapter_rank=4,
        use_mem_rope=True, rope_theta=10000, tie_word_embeddings=True,
        rms_norm_eps=1e-5, max_position_embeddings=64,
        attn_implementation="eager")
    torch.manual_seed(0)
    model = tr.Zamba2ForCausalLM(hc).eval()
    for mod in model.modules():
        if hasattr(mod, "time_step_min"):
            mod.time_step_min = 0.0     # the reference has no dt floor
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    cfg = dict(d_model=32, num_heads=4, head_dim=16, d_ff=64, vocab_size=64,
               num_layers=L, hybrid_layer_ids=[6, 11], num_mem_blocks=2,
               adapter_rank=4, stage_layers=6, norm_eps=1e-5,
               rope_theta=10000.0,
               ssm=dict(state_dim=8, head_dim=8, expand=2, conv_width=4,
                        n_groups=2))
    params = R.from_hf(model.state_dict(), cfg)
    tok, _ = _tokens(n=2, S=S)
    with torch.no_grad():
        want = model(tok).logits
        got = R.logits(params, R.hidden(params, tok, cfg))
    _close(got, want, 1e-5, "logits")


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------
def test_layout_matches_reference():
    assert lm.topology(CFG) == "zamba2" and lm.num_stages(CFG) == 3
    assert {k: tuple(s) for k, s in lm.lm_shapes(CFG).items()} == \
        {k: tuple(s) for k, s in R.layout(RC).items()}
    params = _params()
    assert CFG.param_count() == sum(v.numel() for v in params.values())


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_loss_and_trained_leaf_grads_match_reference(stage):
    """At stage s (stages below s frozen, the alignment on): the loss and
    the gradient of every leaf the stage trains; the same leaves train."""
    params = _params()
    g = torch.Generator().manual_seed(5)
    glob = {k: v + 0.01 * torch.randn(v.shape, generator=g)
            for k, v in params.items()}
    tok, lab = _tokens()
    keys = lm_step_leaves(params, CFG, stage, stage - 1)
    assert sorted(keys) == sorted(R.stage_leaves(RC, params, stage,
                                                 stage - 1))
    p = dict(params)
    p.update({k: params[k].detach().requires_grad_() for k in keys})
    loss, _ = ssl_mod.lm_ssl_loss(p, {"tokens": tok, "labels": lab}, CFG,
                                  sub_layers=stage, active_from=stage - 1,
                                  global_params=glob, align_weight=0.01)
    got = grads_of(loss, {k: p[k] for k in keys})
    want_loss, want = R.loss_and_grads(params, keys, tok, lab, RC,
                                       sub_stages=stage,
                                       active_from=stage - 1,
                                       global_params=glob)
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-6 * \
        abs(float(want_loss))
    for k in keys:
        # fp32 on both sides, the scan chunked against the recurrence
        _close(got[k], want[k], 2e-5, k)


def _port_rounds(rounds: int, params, tok, lab, shards):
    fl = FLConfig(num_clients=len(shards), rounds=rounds, local_epochs=1,
                  schedule="lw_fedssl", rounds_per_stage=(0, 0, rounds))
    tc = TrainConfig(batch_size=2, base_lr=0.05)
    out, hist = run_lm_fedssl(CFG, fl, tc, tokens=tok, labels=lab,
                              shards=shards, params=params, device="cpu")
    lrs = [learning_rate(r, rounds, scaled_base_lr(tc.base_lr, 2),
                         tc.lr_schedule) for r in range(rounds)]
    return out, hist, lrs


@pytest.mark.parametrize("rounds", [1, 2])
def test_fl_rounds_match_reference(rounds):
    """LW-FedSSL rounds at stage 3 of 2 clients (weight transfer at the
    stage's start, AdamW, FedAvg): the clients' losses and the model after
    the rounds. Round 2 runs block A's frozen first use with the weights
    that round 1 trained through its second use."""
    params = _params(2)
    tok, lab = _tokens(3, n=8)
    shards = [torch.arange(0, 4), torch.arange(4, 8)]
    out, hist, lrs = _port_rounds(rounds, params, tok, lab, shards)
    model, losses = params, []
    for r in range(rounds):
        model, ls = R.fl_round(model, shards, tok, lab, RC, stage=3,
                               lr=lrs[r], batch=2, new_stage=r == 0)
        losses.append(sum(ls) / len(ls))
    assert hist.loss == pytest.approx(losses, rel=1e-5)
    assert set(out) == set(model)
    moved = 0
    for k in R.stage_leaves(RC, model, 3, 2):
        # AdamW moves each element about lr a step whatever its gradient,
        # so an element whose gradient is nought to rounding moves either
        # way: the change is held to its norm, leaf by leaf
        d_got, d_want = out[k] - params[k], model[k] - params[k]
        if k.startswith("layers/4/") or k.startswith("layers/5/"):
            # weight transfer: stage 3's layers start from stage 2's
            base = params[k.replace("layers/4/", "layers/2/")
                          .replace("layers/5/", "layers/3/")]
            d_got, d_want = out[k] - base, model[k] - base
        gap = float(torch.linalg.vector_norm(d_got - d_want))
        assert gap <= TOL_CHANGE * float(torch.linalg.vector_norm(d_want)), \
            (k, gap)
        moved += int(float(d_want.abs().max()) > 0)
    assert moved > 20
    for k in set(model) - set(R.stage_leaves(RC, model, 3, 2)):
        if not (k.startswith("layers/4/") or k.startswith("layers/5/")):
            assert torch.equal(out[k], params[k]), k


# ---------------------------------------------------------------------------
# kernels' plain paths: the grouped scan, attention at heads of 224
# ---------------------------------------------------------------------------
def test_grouped_scan_equals_per_group_scans():
    """G = 2: each group's heads scanned with that group's B and C alone,
    values and gradients; a (B, S, 1, N) group equals the (B, S, N) form;
    the FLOP formula counts C.B^T once per group."""
    g = torch.Generator().manual_seed(0)
    B, S, H, P, N, G, Q = 2, 32, 4, 8, 16, 2, 8
    xh = torch.randn(B, S, H, P, generator=g)
    dt = torch.rand(B, S, H, generator=g) * 0.2
    a = dt * -torch.rand(H, generator=g)
    Bm, Cm = (torch.randn(B, S, G, N, generator=g) for _ in range(2))
    ins = [t.clone().requires_grad_() for t in (xh, dt, a, Bm, Cm)]
    y, h = ops.ssd_scan(*ins, chunk=Q, return_state=True)
    (y.square().sum() + h.sum()).backward()
    for grp in range(G):
        hs = slice(grp * H // G, (grp + 1) * H // G)
        sub = [t.detach()[:, :, hs].clone().requires_grad_()
               for t in (xh, dt, a)]
        bc = [t[:, :, grp].clone().requires_grad_() for t in (Bm, Cm)]
        yg, hg = ops.ssd_scan(*sub, *bc, chunk=Q, return_state=True)
        assert torch.equal(yg, y[:, :, hs].detach())
        assert torch.equal(hg, h[:, hs].detach())
        (yg.square().sum() + hg.sum()).backward()
        for i, t in enumerate(sub):
            _close(ins[i].grad[:, :, hs], t.grad, 1e-6, f"grad {i}")
        for i, t in enumerate(bc):
            _close(ins[3 + i].grad[:, :, grp], t.grad, 1e-6, "grad B/C")
    one = ops.ssd_scan(xh, dt, a, Bm[:, :, 0], Cm[:, :, 0], chunk=Q)
    _close(ops.ssd_scan(xh, dt, a, Bm[:, :, :1], Cm[:, :, :1], chunk=Q),
           one, 1e-6, "G = 1")
    assert ops.ssd_scan_flops(xh.shape, Bm.shape, Q) - \
        ops.ssd_scan_flops(xh.shape, Bm[:, :, 0].shape, Q) == \
        B * 2 * S * Q * N


def test_grouped_gated_norm():
    """The Mamba2 layer's gated RMSNorm normalises each group apart."""
    from repro_torch.models.layers import mamba2
    g = torch.Generator().manual_seed(1)
    di = CFG.ssm.expand * CFG.d_model
    y, z = (torch.randn(2, 5, di, generator=g) for _ in range(2))
    scale = torch.rand(di, generator=g) + 0.5
    got = mamba2.gated_norm(y, z, scale, CFG)
    h = (y * torch.nn.functional.silu(z)).reshape(2, 5, 2, di // 2)
    want = (h * torch.rsqrt(h.square().mean(-1, keepdim=True) + 1e-5)
            ).reshape(2, 5, di) * scale
    _close(got, want, 1e-6)


def test_flash_attention_224_cpu():
    """Attention at Zamba2-7B's heads of 224 (causal, its q.k scale) on
    the CPU path, against the explicit softmax; the CUDA wrapper takes
    the (224, 224) pair."""
    assert (224, 224) in fa.HEAD_DIMS
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 48, 2, 224, generator=g) for _ in range(3))
    sc = (224 / 2) ** -0.5
    got = ops.flash_attention(q, k, v, causal=True, scale=sc)
    lg = torch.einsum("bshd,bthd->bhst", q, k) * sc
    lg = lg.masked_fill(~torch.ones(48, 48, dtype=torch.bool).tril(),
                        float("-inf"))
    want = torch.einsum("bhst,bthd->bshd", torch.softmax(lg, -1), v)
    _close(got, want, 1e-5)
    assert ops.attention_flops(q.shape, k.shape, True) == \
        2 * 2 * 48 * 48 * 224 * 2 // 2


# ---------------------------------------------------------------------------
# masks, transfer, the wire and the accounting
# ---------------------------------------------------------------------------
STAGE3 = {"final_ln/scale"} | {f"hybrid/2/{k}" for k in
                               ("adapter_a", "adapter_b", "linear")}


def _stage3_leaves(params):
    return STAGE3 | {k for k in params if k.startswith(("layers/4/",
                                                         "layers/5/",
                                                         "mem_blocks/0/"))}


@pytest.mark.parametrize("path, rng, want", [
    ("mem_blocks/0/attn/wq", (2, 3), ("staged", 0, 6)),
    ("mem_blocks/0/attn/wq", (0, 1), ("staged", 0, 0)),
    ("mem_blocks/1/attn/wq", (1, 2), ("staged", 0, 6)),
    ("layers/4/mamba/w_in", (0, 2), ("staged", 0, 0)),
    ("blocks/attn/wq", (1, 3), ("stacked", 1, 3)),
    ("blocks/attn/wq", (3, 9), ("stacked", 3, 4)),
    ("embed/table", (0, 3), None),
    ("final_ln/scale", (2, 3), None)])
def test_stage_piece(path, rng, want):
    """The one rule the masks, the wire and the accounting share: a mapped
    leaf whole or not at all, a stacked leaf's rows in the range, None for
    the leaves each caller's own flags decide."""
    stages = {"mem_blocks/0/attn/wq": frozenset({1, 2}),
              "mem_blocks/1/attn/wq": frozenset({1}),
              "layers/4/mamba/w_in": frozenset({2})}
    a = torch.empty((6, 5) if path.startswith(("mem", "layers"))
                    else (4, 5), device="meta")
    assert stage_piece(path, a, *rng, stages) == want


def test_stage3_masks_wire_and_bytes():
    """Stage 3 trains and uploads exactly its two layers, use 2's LoRA and
    projection, shared block A and the final norm, and downloads every
    leaf; the wire's payload bytes are the accounting's."""
    params = _params()
    stages = lm.leaf_stages(CFG)
    assert stages["mem_blocks/0/attn/wq"] == {1, 2}
    assert stages["mem_blocks/1/attn/wq"] == {1}
    mask = stage_update_mask(params, 3, 2, stages)
    on = {k for k, m in mask.items() if float(m) == 1.0}
    assert on == _stage3_leaves(params)
    assert set(trained_leaves(params, 3, 2, stages)) == on
    plan = next(p for p in __import__(
        "repro_torch.core.schedule", fromlist=["x"]).build_schedule(
            FLConfig(rounds=3, rounds_per_stage=(0, 0, 3)), 3))
    wire = Transport("fp32", stages=stages)
    specs = wire.plan_specs(params, plan)
    up = {"/".join(s.path) for s in specs["upload"].slots}
    assert up == on
    assert {"/".join(s.path) for s in specs["download"].slots} == set(params)
    cb = comm.round_comm_bytes(params, plan, stages=stages)
    assert cb["upload"] == specs["upload"].payload_bytes == \
        4 * sum(params[k].numel() for k in on)
    assert cb["download"] == specs["download"].payload_bytes


def test_published_cut_stage3_bytes():
    """At the benchmark's cut (published widths, layers 0-17) on ``meta``:
    stage 3 uploads 6 Mamba2 layers, one use and shared block A, 0.822
    billion parameters, and downloads all 2.245 billion."""
    cfg = dataclasses.replace(BASE, num_layers=18,
                              hybrid_layer_ids=(6, 11, 17))
    params = {k: torch.empty(s, device="meta")
              for k, s in lm.lm_shapes(cfg).items()}
    plan = __import__("repro_torch.core.schedule", fromlist=["x"]) \
        .build_schedule(FLConfig(rounds=3, rounds_per_stage=(0, 0, 3)),
                        lm.num_stages(cfg))[0]
    cb = comm.round_comm_bytes(params, plan, stages=lm.leaf_stages(cfg))
    mamba = 3584 * (7168 + 7424 + 112) + 7168 * 3584 + 5 * 7424 + 3 * 112 \
        + 7168 + 3584
    shared = 7168 + 3 * 7168 * 7168 + 7168 * 3584 + 3584 + 3 * 3584 * 14336
    use = 3584 * 3584 + 128 * (3584 + 2 * 14336)
    assert cb["upload"] == 4 * (6 * mamba + use + shared + 3584)
    assert cb["download"] == 4 * cfg.param_count() == 4 * 2245451680
    assert cb["upload"] == 4 * 821584352


def test_weight_transfer_copies_the_previous_stage_layers():
    params = _params()
    out = lm.transfer_model(CFG, params, 3)
    for k, v in params.items():
        if k.startswith(("layers/4/", "layers/5/")):
            src = k.replace("layers/4/", "layers/2/").replace("layers/5/",
                                                             "layers/3/")
            assert torch.equal(out[k], params[src]) and out[k] is not \
                params[src]
        else:
            assert out[k] is v
    assert lm.transfer_model(CFG, params, 1) is params


def test_launcher_trains_zamba2_7b(capsys):
    """``--mode lm --arch zamba2-7b`` on the CPU, through all three stages;
    the vmap engine is refused."""
    train.main(["--mode", "lm", "--arch", "zamba2-7b", "--device", "cpu",
                "--rounds", "3", "--clients", "2", "--batch", "2",
                "--samples", "8", "--seq-len", "64"])
    out = capsys.readouterr().out
    assert "round 3/3 stage 3" in out and "final loss" in out
    loss = float(out.split("final loss ")[1].split()[0])
    assert math.isfinite(loss)
    with pytest.raises(SystemExit):
        train.main(["--mode", "lm", "--arch", "zamba2-7b", "--device", "cpu",
                    "--engine", "vmap"])
