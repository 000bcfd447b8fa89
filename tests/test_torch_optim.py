"""The port's optimizers against the JAX package's (``repro.optim``): one
update (two, so that the step count enters) of AdamW, Adafactor and SGD
with momentum, leaf by leaf, states included, with a freeze mask; the
Adafactor state layout (``tests/test_optim.py``) and its per-client init
on the vmap engine; SGDM (no step count) on the vmap engine; and SimCLR
and BYOL states through the checkpoint files of both packages."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import base as jbase
from repro.core import ssl as jssl
from repro.optim import optimizers as jopt
from repro_torch import checkpoint as tckpt
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.federated import client
from repro_torch.federated.driver import run_fedssl
from repro_torch.optim import optimizers as topt

torch.set_num_threads(2)

# leaves: a factored matrix, a client-like stack of factored matrices, a
# matrix too narrow to factor, a vector, and a frozen matrix
SHAPES = {"big": (256, 512), "stack": (3, 200, 130), "thin": (64, 128),
          "vec": (40,), "frozen": (130, 140)}
MAKERS = {"adamw": lambda m: m.make_adamw(weight_decay=0.1),
          "adafactor": lambda m: m.make_adafactor(weight_decay=0.1),
          "sgdm": lambda m: m.make_sgdm(weight_decay=0.1)}
# the same elementwise ops on fp32 inputs; XLA's pow, rsqrt and reductions
# can round the last bit differently from PyTorch's. Relative to each
# element, and for elements near 0 absolute: under half an fp32 step of a
# unit value (measured: 7.9e-9 on an Adafactor parameter)
RTOL, ATOL = 2e-6, 5e-8


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _flat(state, prefix=""):
    """A nested optimizer state as {"a/b/c": array}; ints become arrays."""
    out = {}
    for k, v in state.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = np.asarray(v.numpy() if isinstance(v, torch.Tensor)
                                  else v)
    return out


@pytest.mark.parametrize("name", list(MAKERS))
def test_update_matches_reference(name):
    params, mask = _inputs(0), {k: 0.0 if k == "frozen" else 1.0
                                for k in SHAPES}
    jo, to = MAKERS[name](jopt), MAKERS[name](topt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for step in (1, 2):
        g = _inputs(step)
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                           1e-2, {k: jnp.float32(m) for k, m in mask.items()})
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp, 1e-2,
                           {k: torch.tensor(m) for k, m in mask.items()})
    np.testing.assert_array_equal(tp["frozen"].numpy(), params["frozen"])
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    want, got = _flat(jax.device_get(js)), _flat(ts)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _device_scalars(opt, count, lr):
    """An update's per-step scalars as 0-dim fp32 tensors, as a step
    captured as a CUDA graph holds them."""
    return {k: torch.tensor(v, dtype=torch.float32)
            for k, v in opt.scalars(count, lr).items()}


def _stacked_update(opt, grads, state, params, lr, mask, scalars=None):
    """``opt.update`` under ``torch.func.vmap`` over a client axis, with
    the step count shared, as ``client.stacked_train_step`` calls it."""
    per_leaf, shared = client.shared_opt_state(state)
    new_shared = {}

    def one(g, s, p):
        p, st = opt.update(g, {**s, **shared}, p, lr, mask, scalars=scalars)
        leaf, sh = client.shared_opt_state(st)
        new_shared.update(sh)
        return p, leaf

    params, per_leaf = torch.func.vmap(one)(grads, per_leaf, params)
    return params, {**per_leaf, **new_shared}


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("steps", [1, 2, 5])
@pytest.mark.parametrize("name", list(MAKERS))
def test_device_scalars_give_the_float_updates_bits(name, steps, stacked):
    """An update given its per-step scalars (``Optimizer.scalars``) as
    0-dim tensors is bitwise the update that computes them as Python
    floats from the step count, alone and under ``vmap`` over 3 clients,
    step after step; the step count stays a Python int."""
    opt, lr, C = MAKERS[name](topt), 3e-3, 3
    mask = {k: torch.tensor(0.0 if k == "frozen" else 1.0) for k in SHAPES}

    def leaves(seed):
        t = {k: torch.from_numpy(v) for k, v in _inputs(seed).items()}
        if stacked:
            t = {k: torch.stack([v * (c + 1) for c in range(C)])
                 for k, v in t.items()}
        return t

    update = functools.partial(_stacked_update, opt) if stacked \
        else opt.update
    init = functools.partial(client.stacked_opt_init, opt) if stacked \
        else opt.init
    params = leaves(0)
    runs = []
    for tensors in (False, True):
        p, st = dict(params), init(params)
        for c in range(1, steps + 1):
            sc = _device_scalars(opt, c, lr) if tensors else None
            p, st = update(leaves(c), st, p, lr, mask, scalars=sc)
        runs.append((p, st))
    (p0, s0), (p1, s1) = runs
    for k in SHAPES:
        assert torch.equal(p1[k], p0[k]), k
    f0, f1 = _flat(s0), _flat(s1)
    assert sorted(f1) == sorted(f0)
    for k in f0:
        np.testing.assert_array_equal(f1[k], f0[k], err_msg=k)
    if name != "sgdm":
        assert type(s1["count"]) is int and s1["count"] == steps


def test_adafactor_factored_state_shapes():
    """The reference's layout (``tests/test_optim.py``): row and column
    moments for a (256, 512) matrix, a full one for a short vector."""
    p = {"big": np.ones((256, 512), np.float32),
         "small": np.ones((4,), np.float32)}
    want = _flat(jax.device_get(jopt.make_adafactor().init(
        {k: jnp.asarray(v) for k, v in p.items()})))
    got = _flat(topt.make_adafactor().init(
        {k: torch.from_numpy(v) for k, v in p.items()}))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert got["m/big/vr"].shape == (256,) and got["m/big/vc"].shape == (512,)


def test_vmap_engine_inits_adafactor_per_client():
    """A per-client vector of 128 elements stacked over 128 clients is a
    (128, 128) leaf, which ``opt.init`` on the stack would factor; the vmap
    engine's per-client init keeps each client's full second moment, as
    the sequential engine has it."""
    opt = topt.make_adafactor()
    C, n = 128, 128
    stacked = {"w": torch.randn(n).expand(C, n), "m": torch.randn(C, n, n)}
    assert "vr" in opt.init(stacked)["m"]["w"]          # the wrong layout
    st = client.stacked_opt_init(opt, stacked)
    assert set(st["m"]["w"]) == {"v"} and st["m"]["w"]["v"].shape == (C, n)
    assert st["m"]["m"]["vr"].shape == (C, n)
    assert st["m"]["m"]["vc"].shape == (C, n) and st["count"] == 0


MODEL = dict(arch_id="t-vit", family="dense", num_layers=2, d_model=32,
             num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=0,
             causal=False, compute_dtype="float32", act="gelu")
SSL = dict(proj_hidden=32, pred_hidden=32, proj_dim=16)
# the vmap engine against the sequential one: the bar tests/test_engine.py
# sets for the reference's engines (the same math, batched). Adafactor at
# the AdamW tests' rate: its per-coordinate normalisation (eps 1e-30)
# turns a gradient of rounding noise into a step of about the rate
ENGINE_ATOL = 1e-4
BASE_LR = {"sgdm": 1.5e-2, "adafactor": 1.5e-4}


@pytest.mark.parametrize("optimizer", ["sgdm", "adafactor"])
def test_optimizer_runs_on_vmap_engine(optimizer):
    """SGDM's state has no step count and Adafactor's does; both train on
    the vmap engine as on the sequential one, ragged shards included (the
    second client takes one local step fewer)."""
    imgs = np.random.default_rng(0).uniform(
        size=(80, 32, 32, 3)).astype(np.float32)
    idx = [np.arange(0, 48), np.arange(48, 80)]
    runs = {}
    for engine in ("sequential", "vmap"):
        runs[engine] = run_fedssl(
            tbase.ModelConfig(**MODEL), tbase.SSLConfig(**SSL),
            tbase.FLConfig(num_clients=2, rounds=2, local_epochs=1,
                           schedule="lw_fedssl", server_epochs=1),
            tbase.TrainConfig(batch_size=16, base_lr=BASE_LR[optimizer],
                              optimizer=optimizer),
            images=imgs, client_indices=idx, aux_images=imgs[:16],
            device="cpu", engine=engine)
    (s_seq, h_seq), (s_v, h_v) = runs["sequential"], runs["vmap"]
    np.testing.assert_allclose(h_v.loss, h_seq.loss, atol=ENGINE_ATOL)
    for b in s_seq:
        for k in s_seq[b]:
            np.testing.assert_allclose(s_v[b][k].numpy(), s_seq[b][k].numpy(),
                                       atol=ENGINE_ATOL, err_msg=k)


@pytest.mark.parametrize("method", ["simclr", "byol"])
def test_fl_state_round_trips_with_reference(method, tmp_path):
    """A SimCLR global state (no target, no prediction head) and a BYOL one
    written by either package load into the other bit for bit."""
    cfg = jbase.ModelConfig(**MODEL)
    jstate = jax.device_get(jssl.ssl_init(
        jax.random.PRNGKey(3), jssl.make_vit_encoder(cfg),
        jbase.SSLConfig(**SSL, method=method)))
    state = convert.state_from_numpy(jstate)
    assert set(state) == ({"online"} if method == "simclr"
                          else {"online", "target"})
    jckpt.save_fl_state(tmp_path / "ref", jstate, 5)
    like = {b: {k: torch.zeros_like(v) for k, v in t.items()}
            for b, t in state.items()}
    got, rnd, _ = tckpt.load_fl_state(tmp_path / "ref", like)
    assert rnd == 5 and list(got) == list(state)
    for b in state:
        assert list(got[b]) == list(state[b])
        for k in state[b]:
            assert torch.equal(got[b][k], state[b][k]), (b, k)
    tckpt.save_fl_state(tmp_path / "port", state, 6)
    back, rnd, _ = jckpt.load_fl_state(
        tmp_path / "port", jax.tree.map(jnp.zeros_like, jstate))
    assert rnd == 6
    want, got = convert.flatten_tree(jstate), convert.flatten_tree(
        jax.device_get(back))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
