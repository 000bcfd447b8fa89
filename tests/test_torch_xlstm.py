"""The port's xLSTM LM (the ``xlstm`` topology: groups of mLSTM blocks
closed by one sLSTM block) against the JAX package, at the reduction of the
reference's arch smoke test: ``reduced(xlstm-125m, num_layers=4,
slstm_every=2)``, two stage groups of one mLSTM and one sLSTM block, d 256,
4 heads, mLSTM inner width 512 (heads of 128), fp32 compute unless stated.
Parameters are the reference's ``init_lm`` converted through numpy; inputs
are numpy draws."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import base as jbase
from repro.core import schedule as jsched
from repro.core import ssl as jssl
from repro.data.synthetic import synthetic_tokens
from repro.federated import comm as jcomm
from repro.federated import masks as jmasks
from repro.federated import transport as jtransport
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.models.layers import norms as jnorms
from repro.models.layers import xlstm as jxlstm
from repro_torch import checkpoint as tckpt
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.core import schedule as sched
from repro_torch.core import ssl as tssl
from repro_torch.federated import comm
from repro_torch.federated.masks import stage_update_mask
from repro_torch.federated.transport import Transport
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.models.layers import norms, xlstm

torch.set_num_threads(2)

ARCH = "xlstm-125m"


def _configs(**over):
    j, t = jbase.load_arch(ARCH), tbase.load_arch(ARCH)
    return (jbase.reduced(j, num_layers=4, xlstm=dataclasses.replace(
        j.xlstm, slstm_every=2), **over),
        tbase.reduced(t, **{**train.LM_ARCHS[ARCH], **over}))


JCFG, TCFG = _configs()
# fp32 on both sides: the same math summed in another order (PyTorch's CPU
# matmuls and einsums against XLA's, the sLSTM's recurrence over up to 64
# steps), through up to 2 mLSTM and 2 sLSTM blocks; relative to the largest
# value of each compared tensor
RTOL = 5e-5
GRAD_RTOL = 2e-4


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jlm.init_lm(jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def tparams(jparams):
    return convert.from_numpy_tree(jparams)


def _close(got, want, rtol=RTOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
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


def test_config_copy_and_topology_match_reference():
    full_t, full_j = tbase.load_arch(ARCH), jbase.load_arch(ARCH)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "family", "tie_embeddings", "param_dtype",
              "compute_dtype", "norm_eps"):
        assert getattr(full_t, f) == getattr(full_j, f), f
    assert vars(full_t.xlstm) == vars(full_j.xlstm)
    assert ARCH in tbase.ARCH_IDS
    assert lm.topology(TCFG) == jlm.topology(JCFG) == "xlstm"
    assert lm.num_stages(TCFG) == jlm.num_stages(JCFG) == 2
    assert lm.num_stages(full_t) == jlm.num_stages(full_j) == 2


def test_init_lm_trees_convert_both_ways(jparams, tparams):
    """The reference's tree (``mlstm`` leaves (groups, slstm_every - 1, ...),
    ``slstm`` leaves (groups, ...)) converts to the port's flat dict in
    ``jax.tree_util`` order and back bit for bit; the port's own
    ``init_lm`` has the same leaves, shapes, dtypes and constant initial
    values, and its random weights the reference's spread."""
    flat_ref = [p for p, _ in
                jax.tree_util.tree_flatten_with_path(jparams)[0]]
    keys = ["/".join(str(getattr(k, "key", k)) for k in p) for p in flat_ref]
    assert list(tparams) == keys
    assert list(lm.lm_shapes(TCFG)) == keys
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
    for k in ("mlstm/mlstm/b_f", "mlstm/mlstm/b_i", "mlstm/mlstm/norm/scale",
              "mlstm/ln/scale", "slstm/slstm/b", "slstm/slstm/norm/bias",
              "slstm/slstm/norm/scale", "slstm/ln/scale"):
        torch.testing.assert_close(mine[k], tparams[k], rtol=0, atol=0)
    assert float(tparams["mlstm/mlstm/b_f"].min()) == 3.0
    # fan-in truncated normal weights (the recurrent r: fan-in P, half
    # scale): the same spread
    for k in ("mlstm/mlstm/w_q", "mlstm/mlstm/w_i", "slstm/slstm/r",
              "slstm/slstm/w", "lm_head"):
        assert abs(float(mine[k].std()) / float(tparams[k].std()) - 1) \
            < 0.05, k


def test_fl_state_checkpoints_cross_load_with_reference(jparams, tparams,
                                                        tmp_path):
    """The tree through ``checkpoint.save_fl_state`` / ``load_fl_state``:
    written by the port and read by the reference, and the other way, bit
    for bit, with the round and meta."""
    tckpt.save_fl_state(tmp_path / "port", tparams, 5, {"arch": ARCH})
    jgot, jrnd, jmeta = jckpt.load_fl_state(
        tmp_path / "port", jax.tree.map(jnp.zeros_like, jparams))
    assert jrnd == 5 and jmeta["arch"] == ARCH
    assert jax.tree_util.tree_structure(jgot) == \
        jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(jgot),
                    jax.tree_util.tree_leaves(jparams)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    jckpt.save_fl_state(tmp_path / "ref", jparams, 3)
    got, rnd, _ = tckpt.load_fl_state(
        tmp_path / "ref", {k: torch.zeros_like(v) for k, v in tparams.items()})
    assert rnd == 3 and list(got) == list(tparams)
    for k, v in tparams.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def _layer(params, kind):
    """Group 1's first block of ``kind``: the reference's subtree and the
    port's flat one."""
    stack = convert.subtree(params, kind)
    return {k: (v[1, 0] if kind == "mlstm" else v[1])
            for k, v in stack.items()}


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
                                [xt, *p.values()])
    _close(grads[0], jgx, GRAD_RTOL, msg="d input")
    jflat = convert.flatten_tree(jax.device_get(jgp))
    for k, gk in zip(p, grads[1:]):
        _close(gk, jflat[k], GRAD_RTOL, msg=k)


@pytest.mark.parametrize("S", [32, 512])
def test_mlstm_apply_matches_reference(jparams, tparams, S):
    """S = 32 runs the quadratic, decay-masked form; S = 512 the chunkwise
    form, 2 chunks of 256 with the (C, n, m) state carried between them."""
    jp = jax.tree.map(lambda a: a[1, 0], jparams["mlstm"]["mlstm"])
    tp = convert.subtree(_layer(tparams, "mlstm"), "mlstm")
    x = _x((2, S, JCFG.d_model), seed=S)
    _vjp_check(lambda p, x: jxlstm.mlstm_apply(p, x, JCFG),
               lambda p, x: xlstm.mlstm_apply(p, x, TCFG), jp, tp, x, S + 1)


def test_slstm_apply_matches_reference(jparams, tparams):
    jp = jax.tree.map(lambda a: a[1], jparams["slstm"]["slstm"])
    tp = convert.subtree(_layer(tparams, "slstm"), "slstm")
    x = _x((2, 64, JCFG.d_model), seed=3)
    _vjp_check(lambda p, x: jxlstm.slstm_apply(p, x, JCFG),
               lambda p, x: xlstm.slstm_apply(p, x, TCFG), jp, tp, x, 4)


def test_layernorm_matches_reference():
    x = _x((3, 40, 96), seed=5, scale=3.0) + 1.5
    rng = np.random.default_rng(6)
    sc, b = (rng.standard_normal(96).astype(np.float32) for _ in range(2))
    want = jnorms.layernorm({"scale": sc, "bias": b}, jnp.asarray(x))
    got = norms.layernorm(torch.from_numpy(x), torch.from_numpy(sc),
                          torch.from_numpy(b))
    _close(got, want, 1e-6)


PAIRS = [(None, 0), (1, 0), (1, 1), (2, 1), (2, 2)]


@pytest.mark.parametrize("sub_layers,active_from", PAIRS)
def test_forward_hidden_matches_reference(jparams, tparams, sub_layers,
                                          active_from):
    tok = _tokens(2, 48)
    jx = jlm.embed(jparams, tok, JCFG)
    want, _ = jlm.forward_hidden(jparams, jx, JCFG, sub_layers=sub_layers,
                                 active_from=active_from)
    got, aux = lm.forward_hidden(
        tparams, lm.embed(tparams, torch.from_numpy(tok).long(), TCFG), TCFG,
        sub_layers=sub_layers, active_from=active_from)
    _close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("sub_layers,active_from,align", [
    (1, 0, True), (2, 1, True), (2, 0, False)])
def test_lm_ssl_loss_and_gradients_match_reference(jparams, tparams,
                                                   sub_layers, active_from,
                                                   align):
    """Loss, metrics and the gradient of every leaf (zero where the leaf is
    frozen or unused) against ``jax.value_and_grad`` of the reference's
    ``lm_ssl_loss``; the global model is a perturbed copy."""
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
    jflat = convert.flatten_tree(jax.device_get(jg))
    for (k, v), g in zip(p.items(), grads):
        g = torch.zeros_like(v) if g is None else g
        _close(g, jflat[k], GRAD_RTOL, msg=k)


# bf16: bfloat16 keeps 8 significant bits, a unit roundoff of U = 2^-8
BF16_U = 2.0 ** -8


def test_bf16_lm_ssl_loss_matches_reference(jparams, tparams):
    """The card's compute dtype. Both packages round each matmul output,
    q, k (divided by sqrt(P) rounded to bf16: 11.3125 for 11.3137 at P =
    128), v, the mLSTM's normed output and the sLSTM's input products to
    bf16, in another order of summation; the gates, the mLSTM core and the
    sLSTM recurrence stay fp32 in both. Each limit sits between the port's
    bf16 gap to the reference's bf16 run and the gap of a port that does
    not round as the reference does, both measured on these inputs: the
    hidden states after 4 blocks, 4.6 U of their largest value apart
    (q, k and v computed in fp32: 8.6 U; all of it in fp32: 9.5 U), are
    held to 6 U; the alignment term, which compares mean-pooled hidden
    states, 0.58 U apart (all fp32: 1.45 U), to 1 U. The next-token loss
    at these random weights is a softmax over 512 classes of small logits
    (embeddings of spread 0.02), which bf16 moves by less than the two
    packages' orders of summation do (0.014 U apart; the fp32 loss 0.0004
    U from the reference's bf16 one): the losses are held to U / 16, and
    the precision is held by the hidden states, the alignment and
    ``test_bf16_mlstm_at_published_width_matches_reference``."""
    jcfg16 = dataclasses.replace(JCFG, compute_dtype="bfloat16")
    tcfg16 = dataclasses.replace(TCFG, compute_dtype="bfloat16")
    tok = _tokens(4, 32, seed=11)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    jx = jlm.embed(jparams, tok, jcfg16)
    want, _ = jlm.forward_hidden(jparams, jx, jcfg16)
    got, _ = lm.forward_hidden(tparams, lm.embed(tparams, tbatch["tokens"],
                                                 tcfg16), tcfg16)
    _close(got, want, 6 * BF16_U)
    rng = np.random.default_rng(12)
    jglobal = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype),
        jparams)
    kw = dict(sub_layers=2, active_from=1, align_weight=0.01)
    jl16, jm = jssl.lm_ssl_loss(jparams, batch, jcfg16,
                                global_params=jglobal, **kw)
    jl32, _ = jssl.lm_ssl_loss(jparams, batch, JCFG, global_params=jglobal,
                               **kw)
    with torch.no_grad():
        _, m = tssl.lm_ssl_loss(tparams, tbatch, tcfg16,
                                global_params=convert.from_numpy_tree(
                                    jglobal), **kw)
    assert float(jl16) != float(jl32) and float(m["loss"]) != float(jl32)
    for name in ("xent", "loss"):
        _close(m[name], jm[name], BF16_U / 16, msg=name)
    _close(m["align"], jm["align"], BF16_U, msg="align")


@pytest.mark.parametrize("S", [32, 512])
def test_bf16_mlstm_at_published_width_matches_reference(S):
    """One mLSTM layer at xlstm-125m's published widths (d 768, heads of P
    = 384, where the bf16 key divisor is 19.625 for sqrt(384) = 19.596) in
    bf16, in the quadratic (S = 32) and the chunkwise (S = 512) form,
    against the reference's bf16 layer. The relative L2 distance of the
    outputs is held to 1.4 U: it measures 1.18 U, and 1.70-1.80 U with
    the divisor unrounded, 2.08-2.16 U with q, k and v computed in fp32,
    2.67-2.88 U with the layer in fp32 (CPU, these inputs and S = 32 to
    512)."""
    full_j, full_t = jbase.load_arch(ARCH), tbase.load_arch(ARCH)
    jcfg = dataclasses.replace(full_j, compute_dtype="bfloat16")
    tcfg = dataclasses.replace(full_t, compute_dtype="bfloat16")
    assert xlstm._key_divisor(384, torch.bfloat16) == \
        float(jnp.sqrt(384).astype(jnp.bfloat16)) == 19.625
    two = dataclasses.replace(full_j, num_layers=2, vocab_size=64,
                              xlstm=dataclasses.replace(full_j.xlstm,
                                                        slstm_every=2))
    jp = jax.device_get(jax.tree.map(
        lambda a: a[0, 0],
        jlm.init_lm(jax.random.PRNGKey(1), two)["mlstm"]["mlstm"]))
    tp = convert.from_numpy_tree(jp)
    x = _x((2, S, full_j.d_model), seed=S)
    want = np.asarray(jxlstm.mlstm_apply(jp, jnp.asarray(x), jcfg),
                      np.float32)
    with torch.no_grad():
        got = xlstm.mlstm_apply(tp, torch.from_numpy(x), tcfg).float().numpy()
    assert got.shape == want.shape
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert rel <= 1.4 * BF16_U, rel / BF16_U


def test_layerwise_stage_step_freezes_the_first_group(jparams, tparams):
    """The reference's arch smoke test's stage-2 step
    (``tests/test_arch_smoke.py::test_layerwise_stage_step``): with group 1
    frozen, every leaf of the frozen group gets a gradient of exactly 0,
    in both packages, and the trained group's gradients agree."""
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
    stacked = [k for k in p if k.startswith(("mlstm/", "slstm/"))]
    assert len(stacked) == 18          # 11 mLSTM leaves, 7 sLSTM
    for k in stacked:
        g = grads[k]
        assert g is not None and torch.isfinite(g).all(), k
        assert not g[:1].any() and not np.asarray(jg[k][:1]).any(), k
        assert g[1:].abs().sum() > 0, k
        _close(g, jg[k], GRAD_RTOL, msg=k)


@pytest.mark.parametrize("schedule", ["lw_fedssl", "progressive"])
def test_masks_bytes_and_transfer_match_reference(jparams, tparams,
                                                  schedule):
    """On the xlstm tree: stage masks, analytic bytes and payload slots of
    every round plan, and the weight transfer of every stage on the
    ``mlstm`` and ``slstm`` stacks."""
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
        cb = comm.round_comm_bytes(tparams, plan)
        assert cb == jcomm.round_comm_bytes(jp, jplan)
        for d, js in jwire.plan_specs(jp, jplan).items():
            s = wire.plan_specs(tparams, plan)[d]
            assert [(x.path, x.lo, x.hi, x.offset, x.size)
                    for x in s.slots] == \
                [(x.path, x.lo, x.hi, x.offset, x.size) for x in js.slots]
    moved = {k: v + 1.0 for k, v in tparams.items()}     # rows differ
    for stage in (1, 2):
        want = convert.flatten_tree(jax.device_get(jsched.transfer_model(
            jax.tree.map(jnp.asarray, convert.to_numpy_tree(moved)), JCFG,
            stage)))
        got = sched.transfer_model(moved, stage)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    got = sched.transfer_model(tparams, 2)
    for k in ("mlstm/mlstm/w_q", "slstm/slstm/r"):
        torch.testing.assert_close(got[k][1], tparams[k][0], rtol=0, atol=0)


# --mode lm --arch xlstm-125m: the arch smoke test's reduction, LW-FedSSL
# over its 2 stage groups, 2 clients of 8 sequences of 32 tokens, batch 4 (2
# local steps a round), 4 rounds, fp32
LM_ARGS = ["--mode", "lm", "--arch", ARCH, "--rounds", "4", "--clients",
           "2", "--batch", "4", "--samples", "16", "--seq-len", "32",
           "--seed", "0"]
# the same math on the same data summed in another order, through 4 rounds
# of 2 AdamW steps a client; the vmap engine batches the same steps. Losses:
# the zamba2 and dense launcher tolerance (tests/test_torch_fl_lm.py,
# test_torch_lm_dense.py), measured 3.8e-8 relative here. Parameters: the
# rate (4.7e-6 and falling) bounds what training moves a leaf to 2.3e-5 in
# these rounds; AdamW turns a gradient near rounding level into a step of
# up to the rate in either package, and the sequential engine's trees
# agree to 2e-6, the vmap engine's (batched products summed in another
# order) to 2.04e-6 in 2 of w_q's 524288 elements: held to 4e-6, under a
# fifth of the budget
LOSS_RTOL = 2e-6
PARAM_ATOL = {"sequential": 2e-6, "vmap": 4e-6}


@pytest.mark.parametrize("engine", ["sequential", "vmap"])
def test_launcher_matches_reference(engine, monkeypatch):
    """``python -m repro_torch.launch.train --mode lm --arch xlstm-125m
    --device cpu`` (``run_lm_fedssl`` underneath) against the reference's
    launcher with its ``reduced`` patched to the same override (alone, it
    leaves xlstm-125m 0 stages and divides by zero). The port's tokens and
    initial parameters are replaced by the reference's (its key chain
    ``split(PRNGKey(seed), 3)``); losses, final parameters and the wire
    bytes of every download (and, sequential, upload)."""
    monkeypatch.setattr(jtrain, "reduced", lambda cfg, **kw: jbase.reduced(
        cfg, **{"num_layers": 4, "xlstm": JCFG.xlstm, **kw}))
    wire = {"down": [], "up": []}
    broadcast = jtransport.Transport.broadcast
    aggregate = jtransport.Transport.aggregate_uploads

    def rec_broadcast(self, *a, **k):
        out = broadcast(self, *a, **k)
        wire["down"].append(out[1]["wire_bytes"])
        return out

    def rec_aggregate(self, *a, **k):
        out = aggregate(self, *a, **k)
        wire["up"].append(out[1]["wire_bytes"])
        return out

    monkeypatch.setattr(jtransport.Transport, "broadcast", rec_broadcast)
    monkeypatch.setattr(jtransport.Transport, "aggregate_uploads",
                        rec_aggregate)
    got = {}
    monkeypatch.setattr(jtrain, "train_lm", lambda args, f=jtrain.train_lm:
                        got.setdefault("ref", f(args)))
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
    assert hist.wire_download_bytes == wire["down"] == hist.download_bytes
    if engine == "sequential":
        assert hist.wire_upload_bytes == wire["up"]
    assert hist.wire_upload_bytes == hist.upload_bytes
    want = convert.flatten_tree(jax.device_get(jparams))
    assert list(params) == list(want)
    for k, v in want.items():
        np.testing.assert_allclose(params[k].numpy(), v, rtol=0,
                                   atol=PARAM_ATOL[engine], err_msg=k)


# ---------------------------------------------------------------------------
# the prefill hand-off: return_state and an entering state
# ---------------------------------------------------------------------------
def _state_close(got, want, msg):
    for k in want:
        _close(got[k], want[k], msg=f"{msg} {k}")


@pytest.mark.parametrize("S", [32, 512])
def test_mlstm_return_state_matches_reference(jparams, tparams, S):
    """``return_state`` at S = 32 (the quadratic form, its final state
    replayed from zero) and S = 512 (the chunkwise form's carried state),
    against the reference's output and (C, n, m); each within RTOL of its
    largest value."""
    jp = jax.tree.map(lambda a: a[1, 0], jparams["mlstm"]["mlstm"])
    tp = convert.subtree(_layer(tparams, "mlstm"), "mlstm")
    x = _x((2, S, JCFG.d_model), seed=S + 7)
    want, jst = jxlstm.mlstm_apply(jp, jnp.asarray(x), JCFG,
                                   return_state=True)
    got, st = xlstm.mlstm_apply(tp, torch.from_numpy(x), TCFG,
                                return_state=True)
    _close(got, want, msg="out")
    _state_close(st, jax.device_get(jst), "state")


def test_mlstm_chunkwise_hand_off_matches_reference(jparams, tparams):
    """A 512-token prompt run as two 256-token parts, the first part's
    state entering the second (the chunkwise form carries it); both
    packages, output and state. The two parts equal one pass: the
    chunkwise form's hand-off is exact up to rounding."""
    jp = jax.tree.map(lambda a: a[1, 0], jparams["mlstm"]["mlstm"])
    tp = convert.subtree(_layer(tparams, "mlstm"), "mlstm")
    x = _x((2, 512, JCFG.d_model), seed=11)
    _, j1 = jxlstm.mlstm_apply(jp, jnp.asarray(x[:, :256]), JCFG,
                               return_state=True)
    jy2, j2 = jxlstm.mlstm_apply(jp, jnp.asarray(x[:, 256:]), JCFG,
                                 return_state=True, state=j1)
    _, t1 = xlstm.mlstm_apply(tp, torch.from_numpy(x[:, :256]), TCFG,
                              return_state=True)
    ty2, t2 = xlstm.mlstm_apply(tp, torch.from_numpy(x[:, 256:]), TCFG,
                                return_state=True, state=t1)
    _close(ty2, jy2, msg="second part")
    _state_close(t2, jax.device_get(j2), "state")
    whole = xlstm.mlstm_apply(tp, torch.from_numpy(x), TCFG)
    _close(ty2, whole[:, 256:].detach().numpy(), msg="against one pass")


def test_slstm_state_hand_off_matches_reference(jparams, tparams):
    """The sLSTM's last state, and a second part started from it, against
    the reference's; the two parts equal one pass."""
    jp = jax.tree.map(lambda a: a[1], jparams["slstm"]["slstm"])
    tp = convert.subtree(_layer(tparams, "slstm"), "slstm")
    x = _x((2, 48, JCFG.d_model), seed=13)
    _, j1 = jxlstm.slstm_apply(jp, jnp.asarray(x[:, :24]), JCFG,
                               return_state=True)
    jy2, j2 = jxlstm.slstm_apply(jp, jnp.asarray(x[:, 24:]), JCFG,
                                 return_state=True, state=j1)
    _, t1 = xlstm.slstm_apply(tp, torch.from_numpy(x[:, :24]), TCFG,
                              return_state=True)
    _state_close(t1, jax.device_get(j1), "first state")
    ty2, t2 = xlstm.slstm_apply(tp, torch.from_numpy(x[:, 24:]), TCFG,
                                return_state=True, state=t1)
    _close(ty2, jy2, msg="second part")
    _state_close(t2, jax.device_get(j2), "state")
    whole = xlstm.slstm_apply(tp, torch.from_numpy(x), TCFG)
    _close(ty2, whole[:, 24:].detach().numpy(), msg="against one pass")
