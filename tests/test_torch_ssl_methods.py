"""SimCLR and BYOL in the port against the JAX package: the two losses
(value and gradient), ``ssl_loss`` for the reference's method matrix
(``tests/test_core_ssl.py``), and ``run_fedssl`` with SimCLR + SGD with
momentum and BYOL + Adafactor on both engines, on the reference's
replayed draws. Inputs are numpy draws from a seed; parameters are the
reference's, converted through numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import losses as jlosses
from repro.core import ssl as jssl
from repro.federated.driver import run_fedssl as jax_run_fedssl
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.core import losses, ssl
from repro_torch.federated.driver import run_fedssl
from repro_torch.optim.schedules import learning_rate, scaled_base_lr

from _torch_replay import JaxReplayDraws

torch.set_num_threads(2)

# the reference's method matrix (tests/test_core_ssl.py)
VIT = dict(arch_id="t-vit", family="dense", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=0, causal=False,
           compute_dtype="float32", act="gelu")
SSLC = dict(proj_hidden=64, pred_hidden=64, proj_dim=32)
METHODS = ("moco_v3", "simclr", "byol")
# losses on the same fp32 inputs: the same ops in the same order, so equal
# to the bit except where a reduction or product sums in another order
# (XLA's against PyTorch's); measured below 1e-6 relative
LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-5      # of the largest gradient entry
# ssl_loss through a 2-block ViT and the heads' BatchNorm, fp32: the
# encoder's matmuls and attention sum in another order
SSL_LOSS_RTOL = 2e-5
SSL_GRAD_RTOL = 1e-4  # of each leaf's largest gradient entry
# the projection head's last BatchNorm shift, which the prediction head's
# own BatchNorm subtracts again (moco_v3, byol): its true gradient is 0 and
# its computed one rounding noise, held to SSL_GRAD_RTOL of the largest
# gradient entry of any leaf instead
NOISE_LEAF = "proj/layers/2/bn/bias"


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _grads(fn, *arrays):
    """(value, gradients) of a torch scalar function of ``arrays``."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, allow_unused=True)
    return float(out.detach()), [np.zeros_like(a) if g is None else g.numpy()
                                 for a, g in zip(arrays, grads)]


def _close(got, want, rtol, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (msg, err, scale)


@pytest.mark.parametrize("B,d,tau", [(16, 8, 0.5), (64, 32, 0.2)])
def test_simclr_nt_xent_value_and_grad(B, d, tau):
    z1, z2 = _x((B, d), 0), _x((B, d), 1)
    want, jg = jax.value_and_grad(
        lambda a, b: jlosses.simclr_nt_xent(a, b, tau), argnums=(0, 1))(
        jnp.asarray(z1), jnp.asarray(z2))
    got, tg = _grads(lambda a, b: losses.simclr_nt_xent(a, b, tau), z1, z2)
    _close(got, float(want), LOSS_RTOL, "loss")
    for g, w in zip(tg, jg):
        _close(g, w, GRAD_RTOL, "grad")


@pytest.mark.parametrize("B,d", [(16, 8), (64, 32)])
def test_byol_regression_value_and_grad(B, d):
    q, k = _x((B, d), 2), _x((B, d), 3)
    want, jg = jax.value_and_grad(jlosses.byol_regression)(
        jnp.asarray(q), jnp.asarray(k))
    got, (tg, kg) = _grads(losses.byol_regression, q, k)
    _close(got, float(want), LOSS_RTOL, "loss")
    _close(tg, jg, GRAD_RTOL, "grad")
    assert not kg.any()           # no gradient reaches the target


def _method_state(method):
    jcfg = jbase.ModelConfig(**VIT)
    jsslc = jbase.SSLConfig(**SSLC, method=method)
    jenc = jssl.make_vit_encoder(jcfg)
    jstate = jax.device_get(jssl.ssl_init(jax.random.PRNGKey(0), jenc, jsslc))
    return jenc, jsslc, jstate


@pytest.mark.parametrize("method", METHODS)
def test_ssl_init_layout_matches_reference(method):
    """simclr: no prediction head, no target branch; byol as moco_v3."""
    _, jsslc, jstate = _method_state(method)
    enc = ssl.make_vit_encoder(tbase.ModelConfig(**VIT))
    state = ssl.ssl_init(enc, tbase.SSLConfig(**SSLC, method=method),
                         torch.Generator().manual_seed(0))
    want = {b: {k: v.shape for k, v in convert.flatten_tree(t).items()}
            for b, t in jstate.items()}
    got = {b: {k: tuple(v.shape) for k, v in t.items()}
           for b, t in state.items()}
    assert got == want
    moved = {**state, "online": {k: v + 1 for k, v in
                                 state["online"].items()}}
    after = ssl.momentum_update(moved, 0.9)
    if method == "simclr":
        assert after is moved
    else:
        k = "enc/cls"
        torch.testing.assert_close(after["target"][k],
                                   0.9 * state["target"][k]
                                   + 0.1 * moved["online"][k])


@pytest.mark.parametrize("method", METHODS)
def test_ssl_loss_and_grads_match_reference(method):
    """The reference's method matrix, with the alignment on: loss, its
    terms and every online leaf's gradient, at stage 2 of 2 (block 0
    frozen)."""
    jenc, jsslc, jstate = _method_state(method)
    x1 = _x((8, 32, 32, 3), 4)
    x2 = x1 + 0.01 * _x((8, 32, 32, 3), 5)
    genc = jax.tree.map(lambda a: a * 1.01, jstate["online"]["enc"])
    kw = dict(sub_layers=2, active_from=1, align_weight=0.01)

    def jloss(online):
        loss, m = jssl.ssl_loss({**jstate, "online": online}, x1, x2, jenc,
                                jsslc, global_enc=genc, **kw)
        return loss, m

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jstate["online"])
    state = convert.state_from_numpy(jstate)
    enc = ssl.make_vit_encoder(tbase.ModelConfig(**VIT))
    online = {k: v.requires_grad_() for k, v in state["online"].items()}
    loss, m = ssl.ssl_loss(
        {**state, "online": online}, torch.from_numpy(x1),
        torch.from_numpy(x2), enc, tbase.SSLConfig(**SSLC, method=method),
        global_enc=convert.from_numpy_tree(jax.device_get(genc)), **kw)
    grads = dict(zip(online, torch.autograd.grad(loss, list(online.values()),
                                                 allow_unused=True)))
    for name in ("loss", "con", "align"):
        _close(float(m[name].detach()), float(jm[name]), SSL_LOSS_RTOL, name)
    jg = convert.flatten_tree(jax.device_get(jg))
    top = max(float(np.abs(g).max()) for g in jg.values())
    for k, want in jg.items():
        got = grads[k]
        if not np.abs(want).any():        # the frozen block and the stem
            assert got is None or not got.any(), k
        elif k == NOISE_LEAF and method != "simclr":
            assert float(np.abs(got.numpy() - want).max()) \
                <= SSL_GRAD_RTOL * top, k
        else:
            _close(got.numpy(), want, SSL_GRAD_RTOL, k)


# run_fedssl: a 2-block d 32 ViT, 2 clients, 2 rounds (LW-FedSSL: one stage
# a round), batch 16, with calibration
MODEL = dict(arch_id="t-vit", family="dense", num_layers=2, d_model=32,
             num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=0,
             causal=False, compute_dtype="float32", act="gelu")
SSL = dict(proj_hidden=32, pred_hidden=32, proj_dim=16)
BATCH, ROUNDS, CLIENTS, SAMPLES = 16, 2, 2, 64
# the same math summed in another order through 2 rounds of 2 local steps
# and a calibration step. SGDM at a rate that moves the weights (measured:
# losses within 6e-6 relative, leaves within the tolerance); Adafactor, whose
# per-coordinate normalisation (eps 1e-30) turns any nonzero gradient into
# a step of about the rate, at the AdamW tests' rate, and its noise leaf
# (the prediction-less SimCLR has none) held to twice its 6 steps' rates
RUN_LOSS_RTOL = 1e-4
RUN_PARAM_RTOL, RUN_PARAM_ATOL = 1e-4, 2e-5
BASE_LR = {"sgdm": 1.5e-1, "adafactor": 1.5e-4}


@pytest.mark.parametrize("method,optimizer,engine", [
    ("simclr", "sgdm", "sequential"), ("simclr", "sgdm", "vmap"),
    ("byol", "adafactor", "sequential"), ("byol", "adafactor", "vmap")])
def test_run_fedssl_matches_reference(method, optimizer, engine):
    def configs(mod):
        return (mod.ModelConfig(**MODEL),
                mod.SSLConfig(**SSL, method=method),
                mod.FLConfig(num_clients=CLIENTS, rounds=ROUNDS,
                             local_epochs=1, schedule="lw_fedssl",
                             server_epochs=1),
                mod.TrainConfig(batch_size=BATCH, base_lr=BASE_LR[optimizer],
                                optimizer=optimizer))

    imgs = np.random.default_rng(0).uniform(
        size=(SAMPLES, 32, 32, 3)).astype(np.float32)
    idx = [np.arange(0, 32), np.arange(32, 64)]
    key = jax.random.PRNGKey(0)
    jstate, jhist = jax_run_fedssl(
        *configs(jbase), images=imgs, client_indices=idx,
        aux_images=imgs[:BATCH], key=key, engine=engine)
    state, hist = run_fedssl(
        *configs(tbase), images=imgs, client_indices=idx,
        aux_images=imgs[:BATCH],
        draws=JaxReplayDraws(key, jssl.make_vit_encoder(configs(jbase)[0])),
        device="cpu", engine=engine)
    np.testing.assert_allclose(hist.loss, jhist.loss, rtol=RUN_LOSS_RTOL)
    for name in ("download_bytes", "upload_bytes", "wire_download_bytes",
                 "wire_upload_bytes", "round_stage"):
        assert getattr(hist, name) == getattr(jhist, name), name
    want = convert.flatten_tree(jax.device_get(jstate))
    got = convert.flatten_tree(convert.state_to_numpy(state))
    assert list(got) == list(want)
    assert (method == "simclr") == ("target" not in state)
    rate = scaled_base_lr(BASE_LR[optimizer], BATCH)
    noise_atol = 2 * 3 * sum(learning_rate(r, ROUNDS, rate)
                             for r in range(ROUNDS))
    for k in want:
        atol = noise_atol if k == "online/" + NOISE_LEAF else RUN_PARAM_ATOL
        np.testing.assert_allclose(got[k], want[k], rtol=RUN_PARAM_RTOL,
                                   atol=atol, err_msg=k)


def test_simclr_wire_carries_no_prediction_head():
    """The analytic and wire bytes of a SimCLR round are MoCo v3's less
    the prediction head's leaves, which SimCLR does not have."""
    from repro_torch.core import schedule as sched
    from repro_torch.federated import comm
    from repro_torch.federated.transport import Transport

    enc = ssl.make_vit_encoder(tbase.ModelConfig(**MODEL))
    online = {m: ssl.ssl_init(enc, tbase.SSLConfig(**SSL, method=m), None,
                              "meta")["online"] for m in METHODS}
    pred_b = comm.tree_bytes({k: v for k, v in online["moco_v3"].items()
                              if k.startswith("pred/")})
    assert pred_b > 0
    fl = tbase.FLConfig(rounds=2, schedule="lw_fedssl")
    for plan in sched.build_schedule(fl, 2):
        cb = {m: comm.round_comm_bytes(o, plan) for m, o in online.items()}
        wire = {m: Transport().plan_specs(o, plan)["upload"].payload_bytes
                for m, o in online.items()}
        assert cb["byol"] == cb["moco_v3"] and wire["byol"] == wire["moco_v3"]
        assert cb["simclr"]["upload"] == cb["moco_v3"]["upload"] - pred_b
        assert cb["simclr"]["download"] == cb["moco_v3"]["download"] - pred_b
        assert wire["simclr"] == wire["moco_v3"] - pred_b
