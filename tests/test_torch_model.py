"""The port's model, SSL core, optimizer, augmentation and schedules against
the JAX package, at a small size on the CPU. Parameters are made by the
reference and converted through numpy (``repro_torch.convert``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import heads as jheads
from repro.core import losses as jlosses
from repro.core import schedule as jsched
from repro.core import ssl as jssl
from repro.data import augment as jaug
from repro.federated import masks as jmasks
from repro.federated.leaves import path_keys as jpath_keys
from repro.models import vit as jvit
from repro.optim.optimizers import make_adamw as jmake_adamw
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.core import heads, losses
from repro_torch.core import schedule as sched
from repro_torch.core import ssl as tssl
from repro_torch.data.augment import two_views
from repro_torch.federated.masks import stage_update_mask
from repro_torch.optim.optimizers import make_adamw

from _torch_replay import view_draws

torch.set_num_threads(2)

# a 2-block fp32 ViT with grouped-query attention (4 q heads, 2 kv heads)
SMALL = dict(d_model=64, num_heads=4, num_kv_heads=2, d_ff=128)
JCFG = jbase.reduced(jbase.load_arch("vit-tiny"), **SMALL)
TCFG = tbase.reduced(tbase.load_arch("vit-tiny"), **SMALL)
SSL = dict(proj_hidden=64, pred_hidden=64, proj_dim=32)
# fp32 on both sides; the tolerances cover summation order only
ATOL, RTOL = 2e-5, 1e-4


def _images(n, seed=0):
    return np.random.default_rng(seed).uniform(
        size=(n, 32, 32, 3)).astype(np.float32)


def _flat(tree):
    return convert.flatten_tree(jax.device_get(tree))


def _assert_close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=msg)


def test_convert_round_trip_in_tree_order():
    tree = {"b": {"layers": [{"w": np.full((2,), i, np.float32)}
                             for i in range(12)]},
            "a": np.arange(3, dtype=np.float32)}
    flat = convert.from_numpy_tree(tree)
    want = ["/".join(jpath_keys(p))
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert list(flat) == want
    back = convert.to_numpy_tree(flat)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


CASES = [(sub, act, None) for sub in (1, 2) for act in range(sub + 1)]
CASES.append((2, 1, (0.0, 1.0)))      # depth-dropout gates


@pytest.mark.parametrize("sub,act,gates", CASES)
def test_vit_forward_and_grads_match_reference(sub, act, gates):
    jparams = jvit.init_vit(jax.random.PRNGKey(0), JCFG)
    x = _images(4)
    r = np.random.default_rng(1).standard_normal((4, 64)).astype(np.float32)
    jg = None if gates is None else jnp.asarray(gates, jnp.float32)

    def jloss(p):
        out = jvit.vit_forward(p, jnp.asarray(x), JCFG, sub_layers=sub,
                               active_from=act, layer_gates=jg)
        return jnp.sum(out * r), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    enc = tssl.make_vit_encoder(TCFG)
    params = {k: v.requires_grad_() for k, v in
              convert.from_numpy_tree(jax.device_get(jparams)).items()}
    out = enc.apply(params, torch.from_numpy(x), sub, act,
                    None if gates is None else torch.tensor(gates))
    _assert_close(out.detach(), jout)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                list(params.values()), allow_unused=True)
    want = _flat(jgrads)
    for (k, p), g in zip(params.items(), grads):
        g = torch.zeros_like(p) if g is None else g
        _assert_close(g, want[k], msg=k)


def test_heads_and_losses_match_reference():
    key = jax.random.PRNGKey(2)
    jp = jheads.proj_init(key, 24, 32, 16)
    x = np.random.default_rng(3).standard_normal((16, 24)).astype(np.float32)
    p = convert.from_numpy_tree(jax.device_get(jp))
    _assert_close(heads.head_apply(p, torch.from_numpy(x)),
                  jheads.head_apply(jp, jnp.asarray(x)))
    a, b, c, d = (np.random.default_rng(i).standard_normal((16, 8))
                  .astype(np.float32) for i in range(4))
    ta, tb, tc, td = (torch.from_numpy(v) for v in (a, b, c, d))
    _assert_close(losses.info_nce(ta, tb, 0.2), jlosses.info_nce(a, b, 0.2))
    _assert_close(losses.moco_contrastive(ta, tb, tc, td, 0.2),
                  jlosses.moco_contrastive(a, b, c, d, 0.2))
    _assert_close(losses.align_loss(ta, tb, tc, td, 0.2),
                  jlosses.align_loss(a, b, c, d, 0.2))


@pytest.mark.parametrize("align_weight", [0.0, 0.01])
def test_ssl_loss_and_grads_match_reference(align_weight):
    jenc = jssl.make_vit_encoder(JCFG)
    jssl_cfg = jbase.SSLConfig(**SSL)
    jstate = jssl.ssl_init(jax.random.PRNGKey(4), jenc, jssl_cfg)
    x1, x2 = _images(8, 5), _images(8, 6)
    genc = jstate["online"]["enc"]

    def jloss(online):
        return jssl.ssl_loss({**jstate, "online": online}, jnp.asarray(x1),
                             jnp.asarray(x2), jenc, jssl_cfg, sub_layers=2,
                             active_from=1, global_enc=genc,
                             align_weight=align_weight)

    (jl, jm), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jstate["online"])
    state = convert.state_from_numpy(jax.device_get(jstate))
    online = {k: v.requires_grad_() for k, v in state["online"].items()}
    enc = tssl.make_vit_encoder(TCFG)
    loss, m = tssl.ssl_loss(
        {**state, "online": online}, torch.from_numpy(x1),
        torch.from_numpy(x2), enc, tbase.SSLConfig(**SSL), sub_layers=2,
        active_from=1, global_enc=convert.subtree(state["online"], "enc"),
        align_weight=align_weight)
    assert set(m) == set(jm)
    for name in m:
        _assert_close(m[name].detach(), jm[name], msg=name)
    grads = torch.autograd.grad(loss, list(online.values()),
                                allow_unused=True)
    want = _flat(jgrads)
    for (k, p), g in zip(online.items(), grads):
        # through InfoNCE at tau = 0.2 and the heads' BatchNorms, summation
        # order moves a gradient by up to 1e-4 of its leaf's largest one
        _assert_close(torch.zeros_like(p) if g is None else g, want[k],
                      atol=1e-4 * np.abs(want[k]).max() + 1e-7, msg=k)


def test_momentum_update_matches_reference():
    jenc = jssl.make_vit_encoder(JCFG)
    jstate = jssl.ssl_init(jax.random.PRNGKey(7), jenc,
                           jbase.SSLConfig(**SSL))
    jstate["online"] = jax.tree.map(lambda a: a + 0.5, jstate["online"])
    want = _flat(jssl.momentum_update(jstate, 0.99)["target"])
    got = tssl.momentum_update(
        convert.state_from_numpy(jax.device_get(jstate)), 0.99)["target"]
    assert list(got) == list(want)
    for k in want:
        _assert_close(got[k], want[k], atol=1e-7, rtol=1e-6, msg=k)


def test_adamw_ten_masked_steps_match_reference():
    rng = np.random.default_rng(8)
    tree = {"enc": {"blocks": {"w": rng.standard_normal((3, 4, 5))},
                    "final_ln": {"scale": rng.standard_normal(5)},
                    "patch": rng.standard_normal((4, 5))},
            "proj": {"layers": [{"w": rng.standard_normal((5, 6))}]}}
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    jopt, opt = jmake_adamw(weight_decay=0.05), make_adamw(weight_decay=0.05)
    jp, p = jax.tree.map(jnp.asarray, tree), convert.from_numpy_tree(tree)
    jmask = jmasks.stage_update_mask(jp, 2, 1)
    mask = stage_update_mask(p, 2, 1)
    for k, m in _flat(jmask).items():
        np.testing.assert_array_equal(np.broadcast_to(mask[k], m.shape), m)
    js, s = jopt.init(jp), opt.init(p)
    for step in range(10):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                         .astype(np.float32), tree)
        lr = 1e-2 / (step + 1)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             np.float32(lr), jmask)
        p, s = opt.update(convert.from_numpy_tree(g), s, p, lr, mask)
    want = _flat(jp)
    # elementwise fp32 on both sides; the bias-correction powers round
    # in another order
    for k in want:
        _assert_close(p[k], want[k], atol=1e-7, rtol=1e-5, msg=k)
    np.testing.assert_array_equal(p["enc/patch"].numpy(), tree["enc"]["patch"])


def test_augmentation_given_reference_draws():
    images = _images(6, 9)
    key = jax.random.PRNGKey(10)
    jv1, jv2 = jaug.two_views(key, jnp.asarray(images))
    v1, v2 = two_views(torch.from_numpy(images), *view_draws(key, 6))
    _assert_close(v1, jv1, atol=1e-5, rtol=0)
    _assert_close(v2, jv2, atol=1e-5, rtol=0)


@pytest.mark.parametrize("schedule", jsched.SCHEDULES)
@pytest.mark.parametrize("allocation", ["uniform", "right_skewed",
                                        "left_skewed"])
def test_schedules_match_reference(schedule, allocation):
    kw = dict(rounds=30, schedule=schedule, stage_allocation=allocation,
              depth_dropout=0.3)
    want = jsched.build_schedule(jbase.FLConfig(**kw), 6)
    got = sched.build_schedule(tbase.FLConfig(**kw), 6)
    assert [tuple(vars(p).values()) for p in got] == \
        [tuple(vars(p).values()) for p in want]


def test_weight_transfer_and_gates_match_reference():
    jparams = jvit.init_vit(jax.random.PRNGKey(11), JCFG)
    want = _flat(jsched.transfer_model(jparams, None, 2))
    got = sched.transfer_model(
        convert.from_numpy_tree(jax.device_get(jparams)), 2)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    key = jax.random.PRNGKey(12)
    jgates = jsched.depth_dropout_gates(key, 6, 3, 0.5)
    gates = sched.depth_dropout_gates(
        torch.from_numpy(np.array(jax.random.uniform(key, (6,)))), 3, 0.5)
    np.testing.assert_array_equal(gates.numpy(), np.asarray(jgates))


# bf16: bfloat16 keeps 8 significant bits, a unit roundoff of U = 2^-8
BF16_U = 2.0 ** -8


def test_bf16_forward_and_ssl_loss_match_reference():
    """The main path's compute dtype. Both packages round every matmul
    output to bf16; the reference's ``sdpa_dense`` also rounds the q.k
    logits and the softmax probabilities to bf16, where the port's
    attention keeps both in fp32. Each rounding moves a value by at most U
    of its size, so over 2 blocks (q/k/v, logits, probabilities, attention
    output, wo, MLP up and down in each) the encoder outputs may differ by a
    few U of their largest value: 4 U.

    The SSL loss sees the features through the heads' BatchNorm, which
    divides by their spread over the batch of 8; on these inputs that
    spread is small against their size, so the rounding is amplified there
    in both packages alike. Two bf16 evaluations of the loss each differ
    from the fp32 loss by about the reference's own bf16 error e, so from
    each other by up to 2 e: they are held to 3 e, relative."""
    cfg32, cfg16 = (dataclasses.replace(JCFG, compute_dtype=d)
                    for d in ("float32", "bfloat16"))
    tcfg16 = dataclasses.replace(TCFG, compute_dtype="bfloat16")
    jenc, enc = jssl.make_vit_encoder(cfg16), tssl.make_vit_encoder(tcfg16)
    jssl_cfg = jbase.SSLConfig(**SSL)
    jstate = jssl.ssl_init(jax.random.PRNGKey(4), jenc, jssl_cfg)
    state = convert.state_from_numpy(jax.device_get(jstate))
    genc = jstate["online"]["enc"]
    x = _images(8, 0)
    jout = np.asarray(jvit.vit_forward(genc, jnp.asarray(x), cfg16,
                                       sub_layers=2, active_from=0),
                      np.float32)
    out = enc.apply(convert.subtree(state["online"], "enc"),
                    torch.from_numpy(x), 2, 0, None)
    assert out.dtype == torch.float32
    _assert_close(out, jout, atol=4 * BF16_U * np.abs(jout).max(), rtol=0)

    x1, x2 = _images(8, 5), _images(8, 6)
    kw = dict(sub_layers=2, active_from=1, global_enc=genc,
              align_weight=0.01)
    jl16, jm = jssl.ssl_loss(jstate, jnp.asarray(x1), jnp.asarray(x2), jenc,
                             jssl_cfg, **kw)
    jl32, _ = jssl.ssl_loss(jstate, jnp.asarray(x1), jnp.asarray(x2),
                            jssl.make_vit_encoder(cfg32), jssl_cfg, **kw)
    with torch.no_grad():
        _, m = tssl.ssl_loss(
            state, torch.from_numpy(x1), torch.from_numpy(x2), enc,
            tbase.SSLConfig(**SSL), sub_layers=2, active_from=1,
            global_enc=convert.subtree(state["online"], "enc"),
            align_weight=0.01)
    e = abs(float(jl16) - float(jl32)) / abs(float(jl16))
    assert e > 0.0                   # bf16 did round
    for name in ("con", "loss"):
        _assert_close(m[name], jm[name], atol=0, rtol=3 * e, msg=name)
    _assert_close(m["align"], jm["align"], atol=0, rtol=4 * BF16_U,
                  msg="align")
