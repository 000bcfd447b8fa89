"""The port's MoE family against the JAX package: the MoE FFN and its
dispatch (``repro.models.blocks._moe_ffn``: the per-sample capacity branch
and the dense S == 1 branch, top-1 and top-2, with ties forced in the
router and in the capacity selection), the shared experts, the ``moe``
block, and llama4-maverick's ``moe_il`` topology at ``reduced(...,
num_layers=4)``: two stage groups of one dense and one MoE block, so that a
frozen prefix exists, d 256, 4 heads of 64 (GQA 4/2), 4 routed experts of
width 256 top-1 and one shared expert, fp32. Then the round program and
the launcher (``reduced()``: one group) against the reference's.
Parameters are the reference's ``init_lm`` converted through numpy; inputs
are numpy draws."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from repro.configs import base as jbase
from repro.core import schedule as jsched
from repro.core import ssl as jssl
from repro.data.partition import stack_shards as jstack_shards
from repro.data.synthetic import synthetic_tokens
from repro.federated import comm as jcomm
from repro.federated import masks as jmasks
from repro.federated import transport as jtransport
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models.layers import moe as jmoe
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.core import schedule as sched
from repro_torch.core import ssl as tssl
from repro_torch.federated import comm
from repro_torch.federated.masks import stage_update_mask
from repro_torch.federated.transport import Transport
from repro_torch.launch import steps, train
from repro_torch.models import blocks, lm
from repro_torch.models.layers import moe

torch.set_num_threads(2)

ARCH = "llama4-maverick-400b-a17b"
JCFG = jbase.reduced(jbase.load_arch(ARCH), num_layers=4)
TCFG = tbase.reduced(tbase.load_arch(ARCH), num_layers=4)
# fp32 on both sides: the same math summed in another order (PyTorch's CPU
# matmuls and einsums against XLA's) through up to 4 blocks, with the same
# experts chosen and the same tokens dropped; relative to the largest value
# of each compared tensor
RTOL = 5e-5
GRAD_RTOL = 2e-4
# The router's gradient through the routed outputs sums terms as large as
# the other leaves' gradients, which cancel: with top-1 routing a routed
# token's weight is p / p = 1, whose derivative is 0, so that gradient is
# what rounding leaves of them (measured 2.7e-6 to 5.4e-6 apart, against
# expert gradients up to 20). It is held to GRAD_RTOL of the largest leaf
# gradient; the router's gradient through the load-balance loss alone is
# checked at GRAD_RTOL of its own size.
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


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _tokens(B, S, seed=0, cfg=JCFG):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _grads_close(got, want, cancelling, rtol=GRAD_RTOL):
    """{leaf: gradient} of the port (None for no gradient) against the
    reference's; with ``cancelling``, the router as ``CANCELLING``
    says."""
    top = max(float(np.abs(v).max()) for v in want.values())
    for k, w in want.items():
        g = got[k]
        g = np.zeros(np.shape(w), np.float32) if g is None else g
        _close(g, w, rtol, msg=k,
               scale=top if cancelling and k.split("/")[-1] == CANCELLING
               else None)


def _vjp_check(jfn, tfn, jp, tp, x, seed):
    """Value, aux and the gradients w.r.t. the input and every leaf: of
    <out, g> for a random cotangent g, and of the aux alone."""
    (want, jaux), pull = jax.vjp(jfn, jp, jnp.asarray(x))
    g = _x(want.shape, seed)
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    got, aux = tfn(p, xt)
    _close(got, want, msg="value")
    _close(aux, jaux, 1e-6, msg="aux")
    for cot in ((g, 0.0), (np.zeros_like(g), 1.0)):
        jgp, jgx = pull((jnp.asarray(cot[0]), jnp.float32(cot[1])))
        out = (got * torch.from_numpy(cot[0])).sum() + cot[1] * aux
        grads = torch.autograd.grad(out, [xt, *p.values()],
                                    allow_unused=True, retain_graph=True)
        if cot[1] == 0.0:
            _close(grads[0], jgx, GRAD_RTOL, msg="d input")
        _grads_close(dict(zip(p, grads[1:])),
                     convert.flatten_tree(jax.device_get(jgp)),
                     cancelling=cot[1] == 0.0)


def test_configs_copy_and_topology_match_reference():
    for arch in (ARCH, "deepseek-v2-236b"):
        full_t, full_j = tbase.load_arch(arch), jbase.load_arch(arch)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "family", "head_dim",
                  "tie_embeddings", "param_dtype", "compute_dtype",
                  "source"):
            assert getattr(full_t, f) == getattr(full_j, f), (arch, f)
        assert vars(full_t.moe) == vars(full_j.moe), arch
        assert (full_t.mla is None) == (full_j.mla is None)
        if full_t.mla is not None:
            assert vars(full_t.mla) == vars(full_j.mla)
        assert vars(tbase.load_train(arch)) == vars(jbase.load_train(arch))
        assert arch in tbase.ARCH_IDS
        assert full_t.param_count() == full_j.param_count()
        for over in ({}, {"num_layers": 4}):
            t, j = tbase.reduced(full_t, **over), jbase.reduced(full_j, **over)
            assert lm.topology(t) == jlm.topology(j)
            assert lm.num_stages(t) == jlm.num_stages(j)
    assert lm.topology(TCFG) == "moe_il" and lm.num_stages(TCFG) == 2
    assert lm.num_stages(tbase.reduced(tbase.load_arch(ARCH))) == 1


def test_init_lm_trees_convert_both_ways(jparams, tparams):
    """The reference's tree (``blocks`` leaves (groups, moe_every - 1, ...),
    ``moe_blocks`` leaves (groups, ...), expert weights (..., E, d, f))
    converts to the port's flat dict in ``jax.tree_util`` order and back
    bit for bit; the port's own ``init_lm`` has the same leaves, shapes and
    dtypes, and its random weights the reference's spread (the router at a
    tenth of the fan-in scale, the experts' fan-in their dim 1)."""
    flat_ref = [p for p, _ in
                jax.tree_util.tree_flatten_with_path(jparams)[0]]
    keys = ["/".join(str(getattr(k, "key", k)) for k in p) for p in flat_ref]
    assert list(tparams) == keys
    assert list(lm.lm_shapes(TCFG)) == keys
    assert tparams["moe_blocks/moe/w_gate"].shape == (2, 4, 256, 256)
    assert tparams["blocks/mlp/w_up"].shape == (2, 1, 256, 512)
    back = convert.to_numpy_tree(tparams)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    mine = lm.init_lm(TCFG, torch.Generator().manual_seed(0))
    assert list(mine) == keys
    for k, v in tparams.items():
        assert mine[k].shape == v.shape and mine[k].dtype == v.dtype, k
    for k in ("moe_blocks/moe/router", "moe_blocks/moe/w_gate",
              "moe_blocks/moe/w_down", "moe_blocks/moe/shared/w_up",
              "blocks/attn/wq", "blocks/mlp/w_down"):
        assert abs(float(mine[k].std()) / float(tparams[k].std()) - 1) \
            < 0.05, k


def _moe_layer(jparams, tparams, gi=1):
    jp = jax.tree.map(lambda a: a[gi], jparams["moe_blocks"]["moe"])
    tp = {k: v[gi] for k, v in
          convert.subtree(convert.subtree(tparams, "moe_blocks"),
                          "moe").items()}
    return jp, tp


def _tie_router(jp, tp):
    """Experts 0 and 1 with the same router column: every token's router
    probabilities tie between them."""
    r = np.array(jp["router"])
    r[:, 1] = r[:, 0]
    jp = {**jp, "router": jnp.asarray(r)}
    return jp, {**tp, "router": torch.from_numpy(r)}


def _crowd_router(jp, tp):
    """Expert 0's router column scaled up, so most tokens route to it and
    its capacity drops some: with top-1 every routed token's weight is
    exactly 1.0, so which tokens it keeps is decided among ties."""
    r = np.array(jp["router"])
    r[:, 0] *= 40.0
    jp = {**jp, "router": jnp.asarray(r)}
    return jp, {**tp, "router": torch.from_numpy(r)}


def _capacity_ties(jp, x, jcfg) -> bool:
    """Whether some expert of some row has more routed tokens than its
    capacity and a tie between its last kept and first dropped token's
    weight, by the reference's own routing."""
    m = jcfg.moe
    S = x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(jp["router"]), -1)
    topv, topi = jax.lax.top_k(probs, m.experts_per_token)
    topv = topv / jnp.sum(topv, -1, keepdims=True)
    w = np.asarray(jnp.sum(jax.nn.one_hot(topi, m.num_experts)
                           * topv[..., None], axis=2)).transpose(0, 2, 1)
    cap = int(S * m.experts_per_token * m.capacity_factor / m.num_experts)
    w = -np.sort(-w, axis=-1)
    return bool(np.any((w[..., cap] > 0) & (w[..., cap] == w[..., cap - 1])))


# (experts a token, S, what is forced): S = 1 runs the dense decode branch;
# "capacity" crowds expert 0 at top-1, where every routed weight is 1.0;
# "repeat" crowds it at top-2 with rows of x repeated in threes, so equal
# weights straddle the capacity's edge
MOE_CASES = [(1, 32, None), (2, 32, None), (1, 32, "router"),
             (2, 32, "router"), (1, 32, "capacity"), (2, 32, "repeat"),
             (1, 1, None), (2, 1, "router")]


@pytest.mark.parametrize("k,S,forced", MOE_CASES)
def test_moe_ffn_matches_reference(jparams, tparams, k, S, forced):
    """``moe_ffn`` against the reference's ``_moe_ffn``: output, the
    weighted load-balance loss, and the gradients through both (router
    included) w.r.t. the input and every leaf. Where ties are forced, the
    lowest index wins in both packages, so the same experts are chosen
    and the same tokens kept."""
    jcfg = dataclasses.replace(JCFG, moe=dataclasses.replace(
        JCFG.moe, experts_per_token=k))
    tcfg = dataclasses.replace(TCFG, moe=dataclasses.replace(
        TCFG.moe, experts_per_token=k))
    jp, tp = _moe_layer(jparams, tparams)
    if forced == "router":
        jp, tp = _tie_router(jp, tp)
    elif forced in ("capacity", "repeat"):
        jp, tp = _crowd_router(jp, tp)
    # S = 1 rows: 8 of them, so that the routed shares are not all equal
    # (the load-balance loss is then a constant, its gradient 0)
    x = _x((2 if S > 1 else 8, S, JCFG.d_model), seed=10 * k + S)
    if forced == "repeat":
        x = x[:, np.arange(S) % 11]
    if forced in ("capacity", "repeat"):
        # ties in the capacity selection decide which tokens are kept
        assert _capacity_ties(jp, x, jcfg)
    _vjp_check(lambda p, x: jblocks._moe_ffn(p, x, jcfg),
               lambda p, x: moe.moe_ffn(p, x, tcfg), jp, tp, x, k + S)


def test_capacity_drops_tokens_as_the_reference_does(jparams, tparams):
    """The crowded top-1 router: more tokens route to expert 0 than its
    capacity (10 of 32), and the tokens the port keeps are the
    reference's (the lowest positions); a dropped token's routed output
    is 0 in both."""
    jp, tp = _crowd_router(*_moe_layer(jparams, tparams))
    tp = {k: v for k, v in tp.items() if not k.startswith("shared/")}
    jp = {k: v for k, v in jp.items() if k != "shared"}
    jcfg = dataclasses.replace(JCFG, moe=dataclasses.replace(
        JCFG.moe, num_shared_experts=0))
    tcfg = dataclasses.replace(TCFG, moe=dataclasses.replace(
        TCFG.moe, num_shared_experts=0))
    x = _x((2, 32, JCFG.d_model), seed=3)
    want, _ = jblocks._moe_ffn(jp, jnp.asarray(x), jcfg)
    got, _ = moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    routed = np.asarray(jnp.argmax(jnp.asarray(x) @ jp["router"], -1))
    assert (routed == 0).sum(axis=1).min() > 10
    dropped = np.all(np.asarray(want) == 0, axis=-1)
    assert dropped.any()
    np.testing.assert_array_equal(
        np.all(got.detach().numpy() == 0, axis=-1), dropped)
    _close(got, want)


def test_shared_expert_ffn_matches_reference(jparams, tparams):
    jp, tp = _moe_layer(jparams, tparams, gi=0)
    x = _x((2, 16, JCFG.d_model), seed=4)
    want = jmoe.shared_expert_ffn(jp, jnp.asarray(x), JCFG)
    got = moe.shared_expert_ffn(tp, torch.from_numpy(x), TCFG)
    _close(got, want)
    assert moe.capacity(64, TCFG) == jmoe.capacity(64, JCFG) == 20
    assert moe.capacity(8, TCFG) == jmoe.capacity(8, JCFG) == 4


def test_moe_ffn_under_vmap_matches_each_sample(jparams, tparams):
    """The LM vmap engine's view: ``torch.func.vmap`` over clients (each
    with its own weights and tokens) gives each client's own result, and
    ``torch.func.grad`` runs through it."""
    _, tp = _moe_layer(jparams, tparams)
    x = torch.from_numpy(_x((3, 2, 32, JCFG.d_model), seed=5))
    stacked = {k: torch.stack([v, v * 1.1, v * 0.9]) for k, v in tp.items()}
    out, aux = vmap(lambda p, x: moe.moe_ffn(p, x, TCFG))(stacked, x)
    for c in range(3):
        o, a = moe.moe_ffn({k: v[c] for k, v in stacked.items()}, x[c], TCFG)
        torch.testing.assert_close(out[c], o, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(aux[c], a, rtol=1e-6, atol=1e-8)
    def loss(p, x):
        o, a = moe.moe_ffn(p, x, TCFG)
        return o.sum() + a

    g = vmap(torch.func.grad(loss))(stacked, x)
    assert set(g) == set(tp) and all(torch.isfinite(v).all()
                                     for v in g.values())


@pytest.mark.parametrize("kind", ["moe", "dense"])
def test_block_kinds_match_reference(jparams, tparams, kind):
    """One ``moe`` block (group 1's) and one of llama4's dense blocks,
    value, aux and gradients."""
    if kind == "moe":
        jp = jax.tree.map(lambda a: a[1], jparams["moe_blocks"])
        tp = {k: v[1] for k, v in
              convert.subtree(tparams, "moe_blocks").items()}
    else:
        jp = jax.tree.map(lambda a: a[1, 0], jparams["blocks"])
        tp = {k: v[1, 0] for k, v in
              convert.subtree(tparams, "blocks").items()}
    x = _x((2, 32, JCFG.d_model), seed=6)

    def tfn(p, x):
        y, aux = blocks.block_apply(p, x, TCFG, kind)
        return y, torch.as_tensor(aux, dtype=torch.float32)

    _vjp_check(lambda p, x: jblocks.block_apply(p, x, JCFG, kind), tfn, jp,
               tp, x, 7)


PAIRS = [(None, 0), (1, 0), (2, 0), (2, 1), (2, 2)]


@pytest.mark.parametrize("sub_layers,active_from", PAIRS)
def test_forward_hidden_matches_reference(jparams, tparams, sub_layers,
                                          active_from):
    tok = _tokens(2, 32)
    jx = jlm.embed(jparams, tok, JCFG)
    want, jaux = jlm.forward_hidden(jparams, jx, JCFG, sub_layers=sub_layers,
                                    active_from=active_from)
    got, aux = lm.forward_hidden(
        tparams, lm.embed(tparams, torch.from_numpy(tok).long(), TCFG), TCFG,
        sub_layers=sub_layers, active_from=active_from)
    _close(got, want)
    _close(aux, jaux, 1e-6, msg="aux")
    assert float(aux) > 0


@pytest.mark.parametrize("sub_layers,active_from,align", [
    (1, 0, True), (2, 1, True), (2, 0, False)])
def test_lm_ssl_loss_and_gradients_match_reference(jparams, tparams,
                                                   sub_layers, active_from,
                                                   align):
    """Loss, metrics (the aux among them) and the gradient of every leaf
    (zero where the leaf is frozen or unused) against
    ``jax.value_and_grad`` of the reference's ``lm_ssl_loss``; the global
    model is a perturbed copy."""
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
                                   **kw), has_aux=True)(jparams)
    p = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    loss, m = tssl.lm_ssl_loss(
        p, {k: torch.from_numpy(v).long() for k, v in batch.items()}, TCFG,
        global_params=convert.from_numpy_tree(jglobal), **kw)
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    _close(loss, jl, 1e-5)
    assert set(m) == set(jm)
    for k in jm:
        _close(m[k], jm[k], 1e-5, msg=k)
    _grads_close(dict(zip(p, grads)), convert.flatten_tree(
        jax.device_get(jg)), cancelling=True)


def test_lm_loss_matches_reference(jparams, tparams):
    tok = _tokens(2, 32, seed=8)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    jl, jm = jlm.lm_loss(jparams, batch, JCFG)
    loss, m = lm.lm_loss(tparams, {k: torch.from_numpy(v).long()
                                   for k, v in batch.items()}, TCFG)
    _close(loss, jl, 1e-6)
    _close(m["aux"], jm["aux"], 1e-6)


def test_layerwise_stage_step_freezes_the_first_group(jparams, tparams):
    """The reference's arch smoke test's stage-2 step
    (``tests/test_arch_smoke.py::test_layerwise_stage_step``): with group 1
    frozen, every leaf of the frozen group, its dense and its MoE block,
    gets a gradient of exactly 0 in both packages, and the trained group's
    gradients agree (the router's through the load-balance loss too)."""
    tok = _tokens(2, 32, seed=13)
    batch = {"tokens": tok, "labels": tok}
    jg = convert.flatten_tree(jax.device_get(jax.grad(
        lambda p: jlm.lm_loss(p, batch, JCFG, sub_layers=2,
                              active_from=1)[0])(jparams)))
    p = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    loss, _ = lm.lm_loss(p, {k: torch.from_numpy(v).long()
                             for k, v in batch.items()}, TCFG, sub_layers=2,
                         active_from=1)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()),
                                            allow_unused=True)))
    stacked = [k for k in p if k.startswith(("blocks/", "moe_blocks/"))]
    assert len(stacked) == 9 + 13     # dense: 9 leaves; MoE: 13
    for k in stacked:
        g = grads[k]
        assert g is not None and torch.isfinite(g).all(), k
        assert not g[:1].any() and not np.asarray(jg[k][:1]).any(), k
        assert g[1:].abs().sum() > 0, k
    _grads_close({k: grads[k] for k in stacked},
                 {k: jg[k] for k in stacked}, cancelling=True)


@pytest.mark.parametrize("schedule", ["lw_fedssl", "progressive"])
def test_masks_bytes_and_transfer_match_reference(jparams, tparams,
                                                  schedule):
    """On the moe_il tree: stage masks, analytic bytes and payload slots of
    every round plan, and the weight transfer of every stage, which copies
    the ``blocks`` rows and leaves ``moe_blocks`` alone, as the
    reference's ``transfer_model`` does."""
    kw = dict(rounds=4, schedule=schedule)
    jplans = jsched.build_schedule(jbase.FLConfig(**kw), 2)
    plans = sched.build_schedule(tbase.FLConfig(**kw), 2)
    jp = jax.tree.map(jnp.asarray, jparams)
    jwire, wire = jtransport.Transport("fp32"), Transport()
    for jplan, plan in zip(jplans, plans):
        jm = convert.flatten_tree(jax.device_get(jmasks.stage_update_mask(
            jp, jplan.sub_layers, jplan.active_from)))
        tm = stage_update_mask(tparams, plan.sub_layers, plan.active_from)
        for k in jm:
            np.testing.assert_array_equal(
                np.broadcast_to(tm[k].numpy(), jm[k].shape), jm[k])
        assert comm.round_comm_bytes(tparams, plan) == \
            jcomm.round_comm_bytes(jp, jplan)
        for d, js in jwire.plan_specs(jp, jplan).items():
            s = wire.plan_specs(tparams, plan)[d]
            assert [(x.path, x.lo, x.hi, x.offset, x.size)
                    for x in s.slots] == \
                [(x.path, x.lo, x.hi, x.offset, x.size) for x in js.slots]
    moved = {k: v + 1.0 for k, v in tparams.items()}
    for stage in (1, 2):
        want = convert.flatten_tree(jax.device_get(jsched.transfer_model(
            jax.tree.map(jnp.asarray, convert.to_numpy_tree(moved)), JCFG,
            stage)))
        got = sched.transfer_model(moved, stage)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    got = sched.transfer_model(tparams, 2)
    torch.testing.assert_close(got["blocks/attn/wq"][1],
                               tparams["blocks/attn/wq"][0], rtol=0, atol=0)
    assert got["moe_blocks/moe/w_up"] is tparams["moe_blocks/moe/w_up"]


# make_fl_round_program: 2 clients, 2 local steps, the second client's
# second step padded, fp32, SGD with momentum at rate 1e-2 (measured 6e-8
# apart). SGD, because AdamW's first steps move every element by about
# the rate whatever its gradient's size, so an element whose gradient is
# rounding noise moves either way (0.2 of the rate apart at rate 1e-3,
# with the losses 4.8e-7 apart); the launcher's test holds AdamW end to
# end at the launcher's rate.
ROUND_ATOL = 1e-6
ROUND_LR = 1e-2


@pytest.mark.parametrize("sub_layers,active_from,align", [(1, 0, False),
                                                          (2, 1, True)])
def test_fl_round_program_matches_reference(jparams, sub_layers,
                                            active_from, align):
    """The LM round program on the moe_il tree at stage 1 and stage 2 (the
    first group frozen, the alignment on): each client's final tree and
    last valid loss, FedAvg off, against the reference's program; at
    stage 2 the frozen group's rows of both stacks keep their values."""
    tc = dict(batch_size=4, base_lr=ROUND_LR, optimizer="sgdm")
    key = jax.random.PRNGKey(1)
    toks, labs = synthetic_tokens(key, 16, 32, JCFG.vocab_size)
    shards = [np.arange(0, 8), np.arange(8, 16)]
    jstacked, _ = jstack_shards({"tokens": toks, "labels": labs},
                                [jnp.asarray(s) for s in shards])
    C, T, B = 2, 2, 4
    batch_idx = np.stack([[np.arange(0, B), np.arange(B, 2 * B)]] * C)
    valid = np.array([[True, True], [True, False]])
    w = np.array([0.5, 0.5], np.float32)
    kw = dict(sub_layers=sub_layers, active_from=active_from, align=align,
              fedavg=False)
    jprog, _ = jsteps.make_fl_round_program(JCFG, jbase.TrainConfig(**tc),
                                            **kw)
    jstate = {"params": jparams,
              "global_params": jparams if align else None}
    jout, jloss = jprog(jstate, jstacked, jnp.asarray(batch_idx),
                        jnp.zeros((C, T, 2), jnp.uint32), jnp.asarray(valid),
                        jnp.asarray(w), jnp.float32(ROUND_LR))
    prog, _ = steps.make_fl_round_program(TCFG, tbase.TrainConfig(**tc), **kw)
    tp = convert.from_numpy_tree(jparams)
    out, loss = prog({"params": tp, "global_params": tp if align else None},
                     {k: torch.from_numpy(np.asarray(v)).long()
                      for k, v in jstacked.items()},
                     torch.from_numpy(batch_idx), torch.from_numpy(valid),
                     torch.from_numpy(w), ROUND_LR)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
    for c in range(C):
        want = convert.flatten_tree(jax.device_get(
            jax.tree.map(lambda a, c=c: a[c], jout)))
        assert list(out[c]) == list(want)
        for k in want:
            np.testing.assert_allclose(out[c][k].numpy(), want[k],
                                       atol=ROUND_ATOL, err_msg=k)
            if active_from and k.startswith(("blocks/", "moe_blocks/")):
                assert torch.equal(out[c][k][:1], tp[k][:1]), k


# --mode lm --arch llama4-maverick-400b-a17b: the reference's reduced(), one
# group of a dense and a MoE block (one stage), 2 clients of 8 sequences of
# 32 tokens, batch 4 (2 local steps a round), 4 rounds, fp32
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
    llama4-maverick-400b-a17b --device cpu`` against the reference's
    launcher, which runs the arch at ``reduced()`` as the port's does, on
    the reference's tokens and initial parameters (its key chain
    ``split(PRNGKey(seed), 3)``): losses, final parameters and the wire
    bytes."""
    got = {}
    monkeypatch.setattr(jtrain, "train_lm", lambda a, f=jtrain.train_lm:
                        got.setdefault("ref", f(a)))
    monkeypatch.setattr(sys, "argv", ["train", *LM_ARGS, "--engine", engine])
    jtrain.main()
    jparams, jhist = got["ref"]
    jcfg = jbase.reduced(jbase.load_arch(ARCH))
    kd, ki, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    toks, labs = synthetic_tokens(kd, 16, 32, jcfg.vocab_size)
    init = convert.from_numpy_tree(jax.device_get(jlm.init_lm(ki, jcfg)))
    monkeypatch.setattr(train, "synthetic_tokens", lambda *a: (
        torch.from_numpy(np.asarray(toks)).long(),
        torch.from_numpy(np.asarray(labs)).long()))
    monkeypatch.setattr(lm, "init_lm", lambda *a: dict(init))
    params, hist = train.main([*LM_ARGS, "--engine", engine,
                               "--device", "cpu"])
    assert hist.round_stage == [1, 1, 1, 1]
    np.testing.assert_allclose(hist.loss, jhist, rtol=LOSS_RTOL)
    assert hist.wire_download_bytes == hist.download_bytes
    assert hist.wire_upload_bytes == hist.upload_bytes
    want = convert.flatten_tree(jax.device_get(jparams))
    assert list(params) == list(want)
    for k, v in want.items():
        np.testing.assert_allclose(params[k].numpy(), v, rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# moe_ffn_local: one expert shard (the reference's expert-parallel path)
# ---------------------------------------------------------------------------
LOCAL_E, LOCAL_K, LOCAL_T = 8, 2, 48
LOCAL_JCFG = dataclasses.replace(JCFG, moe=dataclasses.replace(
    JCFG.moe, num_experts=LOCAL_E, experts_per_token=LOCAL_K))
LOCAL_TCFG = dataclasses.replace(TCFG, moe=dataclasses.replace(
    TCFG.moe, num_experts=LOCAL_E, experts_per_token=LOCAL_K))


def _local_weights(seed):
    """Router (d, E) and expert weights (E, d, f), (E, f, d) drawn with
    numpy at the fan-in scale."""
    d, f = LOCAL_JCFG.d_model, LOCAL_JCFG.moe.d_ff_expert
    rng = np.random.default_rng(seed)
    w = {"router": 0.1 * rng.standard_normal((d, LOCAL_E)) / np.sqrt(d),
         "w_gate": rng.standard_normal((LOCAL_E, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((LOCAL_E, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((LOCAL_E, f, d)) / np.sqrt(f)}
    return {k: v.astype(np.float32) for k, v in w.items()}


def _local_shard(w, e_first, e_local):
    """The router whole and the expert dim sliced to the shard, as under
    the reference's ``shard_map``."""
    return {k: v if k == "router" else v[e_first:e_first + e_local]
            for k, v in w.items()}


@pytest.mark.parametrize("e_first", [0, 4, 6])
@pytest.mark.parametrize("forced", [None, "router", "capacity"])
def test_moe_ffn_local_matches_reference(e_first, forced):
    """``moe_ffn_local`` against the reference's for the first, a middle
    and the last shard of 8 experts (2 a shard, 4 for the middle one),
    top-2: the partial output within RTOL of its largest value, ``aux``
    within 1e-6, ``dropped`` exactly. "router" ties two experts' router
    columns (the lowest index wins the token); "capacity" crowds the
    shard's first expert and repeats rows of x, so that equal weights
    straddle the capacity's edge (the lowest token index is kept)."""
    e_local = 4 if e_first == 4 else 2
    w = _local_weights(e_first)
    x = _x((LOCAL_T, LOCAL_JCFG.d_model), seed=e_first + 1)
    if forced == "router":
        w["router"][:, e_first + 1] = w["router"][:, e_first]
    elif forced == "capacity":
        w["router"][:, e_first] *= 40.0
        x = x[np.arange(LOCAL_T) % 7]
    cap = moe.capacity(LOCAL_T, LOCAL_TCFG)
    assert cap == jmoe.capacity(LOCAL_T, LOCAL_JCFG)
    sw = _local_shard(w, e_first, e_local)
    want, jaux = jmoe.moe_ffn_local({k: jnp.asarray(v) for k, v in
                                     sw.items()}, jnp.asarray(x),
                                    LOCAL_JCFG, e_first, e_local, cap)
    got, aux = moe.moe_ffn_local({k: torch.from_numpy(v) for k, v in
                                  sw.items()}, torch.from_numpy(x),
                                 LOCAL_TCFG, e_first, e_local, cap)
    _close(got, want, msg="partial out")
    _close(aux["aux"], jaux["aux"], 1e-6, msg="aux")
    assert int(aux["dropped"]) == int(jaux["dropped"])
    if forced == "capacity":
        assert int(aux["dropped"]) > 0      # the capacity's edge was hit


def test_moe_ffn_local_shards_sum_to_one_call():
    """Four shards of 2 experts, their partial outputs summed, against one
    call over all 8: the same output (within RTOL), the same ``aux`` to
    the bit, and the shards' drops summing to the whole call's."""
    w = {k: torch.from_numpy(v) for k, v in _local_weights(3).items()}
    x = torch.from_numpy(_x((LOCAL_T, LOCAL_JCFG.d_model), seed=5))
    cap = moe.capacity(LOCAL_T, LOCAL_TCFG)
    whole, wa = moe.moe_ffn_local(w, x, LOCAL_TCFG, 0, LOCAL_E, cap)
    parts = [moe.moe_ffn_local(
        {k: v if k == "router" else v[e:e + 2] for k, v in w.items()}, x,
        LOCAL_TCFG, e, 2, cap) for e in range(0, LOCAL_E, 2)]
    _close(sum(p[0] for p in parts), whole.numpy(), msg="summed")
    assert all(torch.equal(p[1]["aux"], wa["aux"]) for p in parts)
    assert sum(int(p[1]["dropped"]) for p in parts) == int(wa["dropped"])
