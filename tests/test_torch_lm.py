"""The port's LM slice (zamba2: Mamba2 blocks and the shared attention
block) against the JAX package, at the reduced size of the reference's
arch smoke test (``reduced()`` with ``num_layers=4, attn_every=2``: two
stage groups of two Mamba2 blocks, d 256, 4 q heads over 2 kv heads, SSM
state 16, head dim 32, chunk 32), fp32 compute. Parameters are the
reference's ``init_lm`` converted through numpy; inputs are numpy draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import schedule as jsched
from repro.core import ssl as jssl
from repro.federated import comm as jcomm
from repro.federated import masks as jmasks
from repro.federated import transport as jtransport
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models.layers import mamba2 as jmamba
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.core import schedule as sched
from repro_torch.core import ssl as tssl
from repro_torch.federated import comm
from repro_torch.federated.masks import stage_update_mask
from repro_torch.federated.transport import (Transport, pack_stage_payload,
                                             unpack_stage_payload)
from repro_torch.models import blocks, lm
from repro_torch.models.layers import mamba2

torch.set_num_threads(2)

SMOKE = dict(num_layers=4, attn_every=2)
JCFG = jbase.reduced(jbase.load_arch("zamba2-2.7b"), **SMOKE)
TCFG = tbase.reduced(tbase.load_arch("zamba2-2.7b"), **SMOKE)
# fp32 on both sides: the same math summed in another order (PyTorch's CPU
# matmuls against XLA's, the SSD scan's chunk products), through up to 4
# Mamba2 blocks and 2 attention blocks; relative to the largest value
RTOL = 5e-5


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jlm.init_lm(jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def tparams(jparams):
    return convert.from_numpy_tree(jparams)


def _close(got, want, rtol=RTOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (msg, err, scale)


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _tokens(B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, JCFG.vocab_size, (B, S)).astype(np.int32)


def test_config_copy_matches_reference():
    full_t, full_j = tbase.load_arch("zamba2-2.7b"), \
        jbase.load_arch("zamba2-2.7b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "attn_every", "family", "act",
              "param_dtype", "compute_dtype", "norm_eps"):
        assert getattr(full_t, f) == getattr(full_j, f), f
    assert vars(full_t.ssm) == vars(full_j.ssm)
    assert "zamba2-2.7b" in tbase.ARCH_IDS


def test_init_lm_trees_convert_both_ways(jparams, tparams):
    """The reference's tree (nested dicts, (groups, attn_every, ...)
    stacked leaves, a shared_attn subtree) converts to the port's flat
    dict in ``jax.tree_util`` order and back bit for bit; the port's own
    ``init_lm`` has the same leaves, shapes and constant initial values."""
    flat_ref = [p for p, _ in
                jax.tree_util.tree_flatten_with_path(jparams)[0]]
    keys = ["/".join(str(getattr(k, "key", k)) for k in p) for p in flat_ref]
    assert list(tparams) == keys
    assert list(lm.lm_shapes(TCFG)) == keys
    back = convert.to_numpy_tree(tparams)
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                              jax.tree_util.tree_flatten_with_path(
                                  jparams)[0]):
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jparams)
    mine = lm.init_lm(TCFG, torch.Generator().manual_seed(0))
    assert list(mine) == keys
    for k, v in tparams.items():
        assert mine[k].shape == v.shape and mine[k].dtype == v.dtype, k
    for leaf in mamba2.CONSTANT_INIT:
        k = f"blocks/mamba/{leaf}"
        torch.testing.assert_close(mine[k], tparams[k], rtol=0, atol=0)
    # fan-in truncated normal weights: the same spread
    for k in ("blocks/mamba/w_in", "shared_attn/mlp/w_gate", "lm_head"):
        assert abs(float(mine[k].std()) / float(tparams[k].std()) - 1) < 0.05


def _block(params, kind):
    if kind == "mamba":
        return {k: v[0, 1] for k, v in convert.subtree(params,
                                                       "blocks").items()}
    return convert.subtree(params, "shared_attn")


def test_mamba2_apply_matches_reference(jparams, tparams):
    x = _x((2, 64, JCFG.d_model))
    jp = jax.tree.map(lambda a: a[0, 1], jparams["blocks"]["mamba"])
    want = jmamba.mamba2_apply(jp, x, JCFG)
    got = mamba2.mamba2_apply(convert.subtree(_block(tparams, "mamba"),
                                              "mamba"),
                              torch.from_numpy(x), TCFG)
    _close(got, want)


@pytest.mark.parametrize("kind", ["mamba", "attn_only"])
def test_block_kinds_match_reference(jparams, tparams, kind):
    x = _x((2, 64, JCFG.d_model), seed=1)
    jp = (jax.tree.map(lambda a: a[0, 1], jparams["blocks"])
          if kind == "mamba" else jparams["shared_attn"])
    want, aux = jblocks.block_apply(jp, x, JCFG, kind)
    got, got_aux = blocks.block_apply(_block(tparams, kind),
                                      torch.from_numpy(x), TCFG, kind)
    _close(got, want, msg=kind)
    assert float(aux) == 0.0 and got_aux == 0.0


PAIRS = [(None, 0)] + [(s, a) for s in (1, 2) for a in range(s + 1)]


@pytest.mark.parametrize("sub_layers,active_from", PAIRS)
def test_forward_hidden_matches_reference(jparams, tparams, sub_layers,
                                          active_from):
    tok = _tokens(2, 64)
    jx = jlm.embed(jparams, tok, JCFG)
    want, _ = jlm.forward_hidden(jparams, jx, JCFG, sub_layers=sub_layers,
                                 active_from=active_from)
    tx = lm.embed(tparams, torch.from_numpy(tok).long(), TCFG)
    _close(tx, jx)
    got, aux = lm.forward_hidden(tparams, tx, TCFG, sub_layers=sub_layers,
                                 active_from=active_from)
    _close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("S", [1024, 96])
def test_xent_loss_matches_reference(jparams, tparams, S):
    """S = 1024 runs the loss in two chunks of LOSS_CHUNK, S = 96 (not a
    multiple) in one; with and without a mask that drops some
    positions."""
    h = _x((2, S, JCFG.d_model), seed=S)
    y = _tokens(2, S, seed=S)
    mask = (np.random.default_rng(S).uniform(size=(2, S)) > 0.2) \
        .astype(np.float32)
    for m in (None, mask):
        want = jlm.xent_loss(jparams, h, y, JCFG, m)
        got = lm.xent_loss(tparams, torch.from_numpy(h),
                           torch.from_numpy(y).long(), TCFG,
                           None if m is None else torch.from_numpy(m))
        _close(got, want, rtol=1e-5)


@pytest.mark.parametrize("sub_layers,active_from", [(None, 0), (1, 0),
                                                     (2, 1)])
def test_lm_loss_matches_reference(jparams, tparams, sub_layers,
                                   active_from):
    tok = _tokens(2, 64, seed=4)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    want, wm = jlm.lm_loss(jparams, batch, JCFG, sub_layers=sub_layers,
                           active_from=active_from)
    got, m = lm.lm_loss(tparams, {k: torch.from_numpy(v).long()
                                  for k, v in batch.items()}, TCFG,
                        sub_layers=sub_layers, active_from=active_from)
    _close(got, want, rtol=1e-5)
    _close(m["xent"], wm["xent"], rtol=1e-5)


def test_xent_loss_chunks_like_one_pass(tparams):
    h = torch.from_numpy(_x((1, 1024, JCFG.d_model), seed=3))
    y = torch.from_numpy(_tokens(1, 1024, seed=3)).long()
    chunked = lm.xent_loss(tparams, h, y, TCFG)
    logits = h @ tparams["lm_head"]
    whole = torch.nn.functional.cross_entropy(logits[0], y[0])
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sub_layers,active_from,align", [
    (1, 0, True), (2, 1, True), (2, 0, False), (2, 2, True)])
def test_lm_ssl_loss_and_gradients_match_reference(jparams, tparams,
                                                   sub_layers, active_from,
                                                   align):
    """Loss, metrics and the gradient of every leaf (zero where the leaf is
    frozen or unused) against ``jax.value_and_grad`` of the reference's
    ``lm_ssl_loss``; the global model is a perturbed copy, as a decoded
    broadcast differs from the client's tree after local steps."""
    tok = _tokens(4, 64, seed=7)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    rng = np.random.default_rng(9)
    jglobal = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype),
        jparams)
    kw = dict(sub_layers=sub_layers, active_from=active_from,
              align_weight=0.01 if align else 0.0)

    def jloss(p):
        return jssl.lm_ssl_loss(p, batch, JCFG, global_params=jglobal, **kw)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    p = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, m = tssl.lm_ssl_loss(p, tbatch, TCFG,
                               global_params=convert.from_numpy_tree(
                                   jglobal), **kw)
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    _close(loss, jl, rtol=1e-5)
    assert set(m) == set(jm)
    for k in jm:
        _close(m[k], jm[k], rtol=1e-5, msg=k)
    jflat = convert.flatten_tree(jax.device_get(jg))
    for (k, v), g in zip(p.items(), grads):
        g = torch.zeros_like(v) if g is None else g
        _close(g, jflat[k], rtol=2e-4, msg=k)


@pytest.mark.parametrize("schedule", ["lw_fedssl", "e2e", "layerwise",
                                      "progressive"])
def test_masks_bytes_slots_and_transfer_match_reference(jparams, tparams,
                                                        schedule):
    """On the zamba tree: stage masks, analytic bytes, payload slots (and
    the packed and unpacked payloads) of every round plan, and the weight
    transfer of every stage (on the top-level block stack)."""
    kw = dict(rounds=4, schedule=schedule)
    S = lm.num_stages(TCFG)
    assert S == jlm.num_stages(JCFG) == 2
    jplans = jsched.build_schedule(jbase.FLConfig(**kw), S)
    plans = sched.build_schedule(tbase.FLConfig(**kw), S)
    jparams = jax.tree.map(jnp.asarray, jparams)
    jwire, wire = jtransport.Transport("fp32"), Transport()
    rng = np.random.default_rng(1)
    for jplan, plan in zip(jplans, plans):
        jm = convert.flatten_tree(jax.device_get(jmasks.stage_update_mask(
            jparams, jplan.sub_layers, jplan.active_from)))
        tm = stage_update_mask(tparams, plan.sub_layers, plan.active_from)
        assert list(tm) == list(jm)
        for k in jm:
            np.testing.assert_array_equal(
                np.broadcast_to(tm[k].numpy(), jm[k].shape), jm[k])
        cb = comm.round_comm_bytes(tparams, plan)
        assert cb == jcomm.round_comm_bytes(jparams, jplan)
        jspecs, specs = jwire.plan_specs(jparams, jplan), \
            wire.plan_specs(tparams, plan)
        for d in ("download", "upload"):
            js, s = jspecs[d], specs[d]
            assert [(x.path, x.kind, x.lo, x.hi, x.shape, x.offset, x.size)
                    for x in s.slots] == \
                [(x.path, x.kind, x.lo, x.hi, x.shape, x.offset, x.size)
                 for x in js.slots]
            assert wire.wire_bytes(s) == jwire.wire_bytes(js) == cb[d]
            flat = pack_stage_payload(tparams, s)
            np.testing.assert_array_equal(
                flat.numpy(),
                np.asarray(jtransport.pack_stage_payload(jparams, js)))
            new = rng.standard_normal(s.total).astype(np.float32)
            got = unpack_stage_payload(tparams, torch.from_numpy(new), s)
            want = convert.flatten_tree(jax.device_get(
                jtransport.unpack_stage_payload(jparams, new, js)))
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), want[k])
    for stage in (1, 2):
        want = convert.flatten_tree(jax.device_get(
            jsched.transfer_model(jparams, JCFG, stage)))
        got = sched.transfer_model(tparams, stage)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_other_topologies_are_refused():
    """No topology is refused any more: a uniform Mamba2 stack (no config
    of the JAX package has one; its decode parity test does), refused
    before, now counts its blocks as stages, as do llama4's interleaved
    MoE and deepseek-v2's MLA + MoE, as the reference counts them."""
    import dataclasses
    base = tbase.reduced(tbase.load_arch("internlm2-1.8b"))
    mamba = dataclasses.replace(base, ssm=tbase.SSMConfig())
    assert lm.topology(mamba) == "uniform" and lm.uniform_kind(mamba) == \
        "mamba"
    assert lm.num_stages(mamba) == jlm.num_stages(dataclasses.replace(
        jbase.reduced(jbase.load_arch("internlm2-1.8b")),
        ssm=jbase.SSMConfig())) == base.num_layers
    for over, stages in ((dict(moe=tbase.MoEConfig(num_experts=4,
                                                   moe_every=2)), 1),
                         (dict(moe=tbase.MoEConfig(num_experts=4),
                               mla=tbase.MLAConfig()), 2)):
        assert lm.num_stages(dataclasses.replace(base, **over)) == stages
