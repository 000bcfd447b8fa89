"""The port's MLA family against the JAX package: multi-head latent
attention (``repro.models.layers.mla.mla_apply``, with and without a q
LoRA), the flash-attention op with a v head narrower than the q/k head
(MLA's (192, 128) and its ``reduced()`` (48, 32)), the ``mla_moe`` block,
and deepseek-v2's ``uniform`` stack of them at ``reduced()``: 2 blocks
(one stage each), d 256, 4 heads, kv rank 64, q/k heads 32 + 16, v heads
32, 4 routed experts of width 256 top-2 and one shared expert, fp32. Then
the launcher against the reference's on both engines. Parameters are the
reference's ``init_lm`` converted through numpy; inputs are numpy draws."""
import dataclasses
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as jbase
from repro.core import schedule as jsched
from repro.core import ssl as jssl
from repro.data.synthetic import synthetic_tokens
from repro.launch import train as jtrain
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models.layers import mla as jmla
from repro.models.layers import sdpa as jsdpa
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.core import schedule as sched
from repro_torch.core import ssl as tssl
from repro_torch.kernels import ops, ref
from repro_torch.launch import train
from repro_torch.models import blocks, lm
from repro_torch.models.layers import mla

torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
JCFG = jbase.reduced(jbase.load_arch(ARCH))
TCFG = tbase.reduced(tbase.load_arch(ARCH))
# fp32 on both sides through up to 2 blocks: the same math summed in
# another order (PyTorch's CPU matmuls, einsums and attention against
# XLA's), the same experts chosen; relative to the largest value of each
# compared tensor
RTOL = 5e-5
GRAD_RTOL = 2e-4
# the router's gradient through the routed outputs sums terms as large as
# the other leaves' gradients, which cancel in part: held to GRAD_RTOL of
# the largest leaf gradient (tests/test_torch_moe.py, ``CANCELLING``)
CANCELLING = "router"


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jlm.init_lm(jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def tparams(jparams):
    return convert.from_numpy_tree(jparams)


def _close(got, want, rtol=RTOL, msg="", scale=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if scale is None else scale, 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (msg, err, scale)


def _grads_close(got, want, rtol=GRAD_RTOL):
    top = max(float(np.abs(v).max()) for v in want.values())
    for k, w in want.items():
        g = got[k]
        g = np.zeros(np.shape(w), np.float32) if g is None else g
        _close(g, w, rtol, msg=k,
               scale=top if k.split("/")[-1] == CANCELLING else None)


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _tokens(B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, JCFG.vocab_size, (B, S)).astype(np.int32)


def _vjp_check(jfn, tfn, jp, tp, x, seed):
    """Value and the gradient of <out, g> w.r.t. the input and every leaf,
    for a random cotangent g."""
    want, pull = jax.vjp(jfn, jp, jnp.asarray(x))
    g = _x(want.shape, seed)
    jgp, jgx = pull(jnp.asarray(g))
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    got = tfn(p, xt)
    _close(got, want, msg="value")
    grads = torch.autograd.grad((got * torch.from_numpy(g)).sum(),
                                [xt, *p.values()], allow_unused=True)
    _close(grads[0], jgx, GRAD_RTOL, msg="d input")
    _grads_close(dict(zip(p, grads[1:])),
                 convert.flatten_tree(jax.device_get(jgp)))


def _attn_layer(jparams, cfg=JCFG, i=1):
    """Block ``i``'s MLA leaves from a reference tree: the reference's
    subtree and the port's flat one."""
    jp = jax.tree.map(lambda a: a[i], jparams["blocks"]["attn"])
    return jp, convert.from_numpy_tree(jp)


def test_config_and_shapes_match_reference(jparams, tparams):
    """The reduced config's MLA, ``mla_shapes`` (with and without a q
    LoRA) against the reference's ``mla_init``, and the tree's leaves, in
    order, against the reference's ``init_lm``; the port's own ``init_lm``
    draws the per-head (H, rank, n) weights at fan-in ``rank``."""
    assert vars(TCFG.mla) == vars(JCFG.mla)
    assert mla.qk_head_dim(TCFG) == 48 and TCFG.mla.v_head_dim == 32
    for q_rank in (0, 48):
        m = dataclasses.replace(JCFG.mla, q_lora_rank=q_rank)
        want = convert.flatten_tree(jax.device_get(jmla.mla_init(
            jax.random.PRNGKey(0), dataclasses.replace(JCFG, mla=m),
            jnp.float32)))
        got = mla.mla_shapes(dataclasses.replace(TCFG, mla=m))
        assert {k: tuple(v.shape) for k, v in want.items()} == got
    keys = ["/".join(str(getattr(k, "key", k)) for k in p) for p, _ in
            jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert list(tparams) == keys == list(lm.lm_shapes(TCFG))
    assert lm.topology(TCFG) == "uniform" and lm.uniform_kind(TCFG) == \
        "mla_moe" and lm.num_stages(TCFG) == 2
    mine = lm.init_lm(TCFG, torch.Generator().manual_seed(0))
    assert list(mine) == keys
    for k in ("blocks/attn/w_uk", "blocks/attn/w_uv", "blocks/attn/w_q",
              "blocks/attn/w_dkv", "blocks/moe/router", "blocks/moe/w_up"):
        assert mine[k].shape == tparams[k].shape
        assert abs(float(mine[k].std()) / float(tparams[k].std()) - 1) \
            < 0.05, k


@pytest.mark.parametrize("q_lora_rank", [0, 48])
def test_mla_apply_matches_reference(jparams, q_lora_rank):
    """``mla_apply``: the latent keys and values, the shared RoPE key, the
    q projection (``w_q``, or ``w_dq`` then ``w_uq``), attention over q/k
    heads of 48 and v heads of 32 at scale 1/sqrt(48), and the output
    projection; value and every gradient."""
    jcfg = dataclasses.replace(JCFG, mla=dataclasses.replace(
        JCFG.mla, q_lora_rank=q_lora_rank))
    tcfg = dataclasses.replace(TCFG, mla=dataclasses.replace(
        TCFG.mla, q_lora_rank=q_lora_rank))
    if q_lora_rank:
        jp = jax.device_get(jmla.mla_init(jax.random.PRNGKey(3), jcfg,
                                          jnp.float32))
        tp = convert.from_numpy_tree(jp)
    else:
        jp, tp = _attn_layer(jparams)
    x = _x((2, 40, JCFG.d_model), seed=q_lora_rank)
    _vjp_check(lambda p, x: jmla.mla_apply(p, x, jcfg),
               lambda p, x: mla.mla_apply(p, x, tcfg), jp, tp, x,
               q_lora_rank + 1)


@pytest.mark.parametrize("S", [32, 512])
def test_bf16_mla_apply_matches_reference(jparams, S):
    """``mla_apply`` in bf16, the card's compute dtype for deepseek-v2.
    Both packages round each projection and q, k, v to bf16; the
    reference's ``sdpa_dense`` also rounds the q.k logits and the
    probabilities to bf16, where the port's attention keeps both in fp32
    (ROADMAP queue 3, "bf16 logits and probabilities"). The relative L2
    distance of the outputs is held to 1.15 U (U = 2^-8): it measures 0.86
    U and 0.89 U, against 1.40 U and 1.41 U for the port's layer in fp32
    (CPU, these inputs, S = 32 and 512)."""
    jcfg = dataclasses.replace(JCFG, compute_dtype="bfloat16")
    tcfg = dataclasses.replace(TCFG, compute_dtype="bfloat16")
    jp, tp = _attn_layer(jparams)
    x = _x((2, S, JCFG.d_model), seed=S)
    want = np.asarray(jmla.mla_apply(jp, jnp.asarray(x), jcfg), np.float32)
    with torch.no_grad():
        got = mla.mla_apply(tp, torch.from_numpy(x), tcfg).float().numpy()
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert rel <= 1.15 * 2.0 ** -8, rel / 2.0 ** -8


# (B, S, Hq, Hkv, q/k head dim, v head dim, causal, window)
NARROW_V = [(2, 40, 4, 4, 48, 32, True, 0), (2, 33, 4, 2, 48, 32, True, 8),
            (1, 20, 2, 2, 192, 128, True, 0),
            (2, 24, 4, 4, 192, 128, False, 0)]


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,dv,causal,window", NARROW_V)
def test_flash_attention_with_a_narrower_v_matches_reference(
        B, S, Hq, Hkv, hd, dv, causal, window):
    """``ops.flash_attention`` (the plain version on the CPU) and its
    ``FlashAttentionFn`` backward (``ref.sdpa_bwd_ref``) with v heads
    narrower than q/k heads, GQA and a window included, against the
    reference's ``sdpa_dense`` at fp32 (kv heads repeated for it) and its
    ``jax.vjp``; the scale is 1/sqrt(q/k head dim), the reference's."""
    rng = np.random.default_rng(B * S + hd)
    q, k = (rng.standard_normal((B, S, h, hd)).astype(np.float32)
            for h in (Hq, Hkv))
    v = rng.standard_normal((B, S, Hkv, dv)).astype(np.float32)
    g = rng.standard_normal((B, S, Hq, dv)).astype(np.float32)
    rep = Hq // Hkv

    def jfn(q, k, v):
        return jsdpa.sdpa_dense(q, jnp.repeat(k, rep, axis=2),
                                jnp.repeat(v, rep, axis=2), causal=causal,
                                window=window, compute_dtype=jnp.float32)

    want, pull = jax.vjp(jfn, *(jnp.asarray(t) for t in (q, k, v)))
    wgrads = pull(jnp.asarray(g))
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    got = ops.flash_attention(*ts, causal=causal, window=window)
    assert got.shape == (B, S, Hq, dv)
    _close(got, want, 1e-5)
    for a, b, n in zip(torch.autograd.grad(got, ts, torch.from_numpy(g)),
                       wgrads, "qkv"):
        _close(a, b, 1e-5, msg=f"d{n}")
    with torch.no_grad():
        plain = ref.sdpa_ref(*(t.transpose(1, 2) for t in ts),
                             causal=causal, window=window,
                             scale=1 / math.sqrt(hd)).transpose(1, 2)
    torch.testing.assert_close(got.detach(), plain, rtol=0, atol=0)


def test_attention_flops_count_the_v_head_dim():
    """The FLOP formula counts q.k^T over the q/k head dim and p.v over the
    v head dim: 2 B Hq S T (hd + dv), halved where causal, which the
    counter reports for one call (one count, by formula)."""
    g = torch.Generator().manual_seed(0)
    q, k = (torch.randn(2, 40, 4, 48, generator=g) for _ in range(2))
    v = torch.randn(2, 40, 4, 32, generator=g)
    for causal in (False, True):
        want = 2 * 2 * 4 * 40 * 40 * (48 + 32) // (2 if causal else 1)
        assert ops.attention_flops(q.shape, k.shape, causal, v.shape) == want
        with FlopCounterMode(display=False) as fc:
            ops.flash_attention(q, k, v, causal=causal)
        assert fc.get_flop_counts()["Global"] == {
            torch.ops.repro_torch.attention_fwd: want}
    assert ops.attention_flops((1, 8, 2, 64), (1, 8, 2, 64), False) == \
        4 * 2 * 8 * 8 * 64


def test_mla_moe_block_matches_reference(jparams, tparams):
    """One ``mla_moe`` block (block 1's): value, aux and the gradient of
    <out, g> + aux."""
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"])
    tp = {k: v[1] for k, v in convert.subtree(tparams, "blocks").items()}
    x = _x((2, 32, JCFG.d_model), seed=6)
    (want, jaux), pull = jax.vjp(
        lambda p, x: jblocks.block_apply(p, x, JCFG, "mla_moe"), jp,
        jnp.asarray(x))
    g = _x(want.shape, 7)
    jgp, jgx = pull((jnp.asarray(g), jnp.float32(1.0)))
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    got, aux = blocks.block_apply(p, xt, TCFG, "mla_moe")
    _close(got, want)
    _close(aux, jaux, 1e-6, msg="aux")
    grads = torch.autograd.grad((got * torch.from_numpy(g)).sum() + aux,
                                [xt, *p.values()])
    _close(grads[0], jgx, GRAD_RTOL, msg="d input")
    _grads_close(dict(zip(p, grads[1:])),
                 convert.flatten_tree(jax.device_get(jgp)))


@pytest.mark.parametrize("sub_layers,active_from,align,remat", [
    (1, 0, True, False), (2, 1, True, False), (2, 0, False, False),
    (2, 1, True, True)])
def test_lm_ssl_loss_and_gradients_match_reference(
        jparams, tparams, sub_layers, active_from, align, remat):
    """Loss, metrics (the aux among them) and the gradient of every leaf
    (zero where frozen or unused) against ``jax.value_and_grad`` of the
    reference's ``lm_ssl_loss``, with and without per-block remat; the
    global model is a perturbed copy."""
    tok = _tokens(4, 32, seed=7)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    rng = np.random.default_rng(9)
    jglobal = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype),
        jparams)
    kw = dict(sub_layers=sub_layers, active_from=active_from,
              align_weight=0.01 if align else 0.0)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jssl.lm_ssl_loss(p, batch, JCFG, global_params=jglobal,
                                   remat=remat, **kw),
        has_aux=True)(jparams)
    p = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    loss, m = tssl.lm_ssl_loss(
        p, {k: torch.from_numpy(v).long() for k, v in batch.items()}, TCFG,
        global_params=convert.from_numpy_tree(jglobal), remat=remat, **kw)
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    _close(loss, jl, 1e-5)
    assert set(m) == set(jm)
    for k in jm:
        _close(m[k], jm[k], 1e-5, msg=k)
    assert float(m["aux"]) > 0
    _grads_close(dict(zip(p, grads)),
                 convert.flatten_tree(jax.device_get(jg)))


def test_layerwise_stage_step_freezes_the_first_block(jparams, tparams):
    """The reference's arch smoke test's stage-2 step: with block 1 frozen,
    every stacked leaf's frozen row gets a gradient of exactly 0 in both
    packages, the trained row's gradients agree, and the frozen block's
    load-balance loss enters the loss without a gradient."""
    tok = _tokens(2, 32, seed=13)
    batch = {"tokens": tok, "labels": tok}
    jg = convert.flatten_tree(jax.device_get(jax.grad(
        lambda p: jlm.lm_loss(p, batch, JCFG, sub_layers=2,
                              active_from=1)[0])(jparams)))
    p = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    loss, m = lm.lm_loss(p, {k: torch.from_numpy(v).long()
                             for k, v in batch.items()}, TCFG, sub_layers=2,
                         active_from=1)
    _, jm = jlm.lm_loss(jparams, batch, JCFG, sub_layers=2, active_from=1)
    _close(m["aux"], jm["aux"], 1e-6)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()),
                                            allow_unused=True)))
    stacked = [k for k in p if k.startswith("blocks/")]
    assert len(stacked) == 2 + 5 + 1 + 7      # norms, MLA, w_q, MoE
    for k in stacked:
        g = grads[k]
        assert g is not None and torch.isfinite(g).all(), k
        assert not g[:1].any() and not np.asarray(jg[k][:1]).any(), k
        assert g[1:].abs().sum() > 0, k
    _grads_close({k: grads[k] for k in stacked}, {k: jg[k] for k in stacked})


def test_transfer_copies_the_mla_moe_rows_as_the_reference_does(tparams):
    moved = {k: v + 1.0 for k, v in tparams.items()}
    for stage in (1, 2):
        want = convert.flatten_tree(jax.device_get(jsched.transfer_model(
            jax.tree.map(jnp.asarray, convert.to_numpy_tree(moved)), JCFG,
            stage)))
        got = sched.transfer_model(moved, stage)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


# --mode lm --arch deepseek-v2-236b: the reference's reduced(), 2 blocks (2
# stages), 2 clients of 8 sequences of 32 tokens, batch 4 (2 local steps a
# round), 4 rounds, fp32
LM_ARGS = ["--mode", "lm", "--arch", ARCH, "--rounds", "4", "--clients",
           "2", "--batch", "4", "--samples", "16", "--seq-len", "32",
           "--seed", "0"]
# the dense launcher tolerances (tests/test_torch_lm_dense.py): the same
# math summed in another order through 4 rounds of 2 AdamW steps a client
LOSS_RTOL = 2e-6
PARAM_ATOL = 2e-6


@pytest.mark.parametrize("engine", ["sequential", "vmap"])
def test_launcher_matches_reference(engine, monkeypatch):
    """``python -m repro_torch.launch.train --mode lm --arch
    deepseek-v2-236b --device cpu`` against the reference's launcher, which
    runs the arch at ``reduced()`` as the port's does, on the reference's
    tokens and initial parameters (its key chain ``split(PRNGKey(seed),
    3)``): losses, final parameters and the wire bytes."""
    got = {}
    monkeypatch.setattr(jtrain, "train_lm", lambda a, f=jtrain.train_lm:
                        got.setdefault("ref", f(a)))
    monkeypatch.setattr(sys, "argv", ["train", *LM_ARGS, "--engine", engine])
    jtrain.main()
    jparams, jhist = got["ref"]
    kd, ki, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    toks, labs = synthetic_tokens(kd, 16, 32, JCFG.vocab_size)
    init = convert.from_numpy_tree(jax.device_get(jlm.init_lm(ki, JCFG)))
    monkeypatch.setattr(train, "synthetic_tokens", lambda *a: (
        torch.from_numpy(np.asarray(toks)).long(),
        torch.from_numpy(np.asarray(labs)).long()))
    monkeypatch.setattr(lm, "init_lm", lambda *a: dict(init))
    params, hist = train.main([*LM_ARGS, "--engine", engine,
                               "--device", "cpu"])
    assert hist.round_stage == [1, 1, 2, 2]
    np.testing.assert_allclose(hist.loss, jhist, rtol=LOSS_RTOL)
    assert hist.wire_download_bytes == hist.download_bytes
    assert hist.wire_upload_bytes == hist.upload_bytes
    want = convert.flatten_tree(jax.device_get(jparams))
    assert list(params) == list(want)
    for k, v in want.items():
        np.testing.assert_allclose(params[k].numpy(), v, rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
